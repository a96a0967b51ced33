"""Backend facts, compile-cache placement, the smoke script's device check
and the native build — the parts of running on an accelerator that the CPU
can check."""

import ctypes
import os
import shutil

import pytest

from relp_tpu import backend
from relp_tpu.utils import cache
from relp_tpu.utils.native_build import NATIVE_DIR, native_library


@pytest.mark.parametrize(
    "platform, f64_native, noisy, host_sparse_auto",
    [("cpu", True, False, True), ("gpu", True, True, False)],
)
def test_backend_facts_table(platform, f64_native, noisy, host_sparse_auto):
    facts = backend.backend_facts(platform)
    assert facts.f64_native is f64_native
    assert (facts.scan_noise_eps > 0) is noisy
    assert facts.host_sparse_auto is host_sparse_auto


def test_backend_facts_refuse_unknown_platform():
    with pytest.raises(backend.UnsupportedBackendError, match="METAL"):
        backend.backend_facts("METAL")


def test_backend_facts_default_is_running_backend():
    assert backend.backend_facts() is backend.backend_facts("cpu")


def test_compile_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.compilation_cache_dir() == os.path.join(repo, ".jax_cache")


def test_compile_cache_dir_follows_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.compilation_cache_dir() == str(tmp_path)


def test_compile_cache_off_on_cpu():
    assert cache.enable_compilation_cache() is None


def test_chip_smoke_refuses_cpu(capsys):
    import json

    import chip_smoke

    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu()
    assert chip_smoke.main([]) == 1
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["ok"] is False


@pytest.mark.parametrize(
    "lib, symbol", [("libmodp.so", "modp_invert"), ("libmps_parser.so", "mps_parse")]
)
def test_native_library_built_from_source(tmp_path, capfd, lib, symbol):
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    src = lib[len("lib"):-len(".so")] + ".cpp"
    for name in ("Makefile", src):
        shutil.copy(os.path.join(NATIVE_DIR, name), tmp_path / name)
    path = native_library(lib, directory=str(tmp_path))
    assert path == str(tmp_path / lib)
    assert f"building {lib}" in capfd.readouterr().err
    assert hasattr(ctypes.CDLL(path), symbol)
    # Fresh now: a second call builds nothing.
    assert native_library(lib, directory=str(tmp_path)) == path
    assert "building" not in capfd.readouterr().err


def test_native_library_missing_source(tmp_path):
    assert native_library("libnothing.so", directory=str(tmp_path)) is None
