"""Smoke test of the exact LP pipeline on one NVIDIA GPU.

Drives the main path once through the entry points a user calls — the CLI
(``python -m relp_tpu solve ... --json --certificate`` and ``verify``, run
in-process so that one process holds the card), ``solve_batch`` and the
``--mip`` / ``--first-order`` CLI paths — on seeded capacitated facility
location instances (Cornuéjols, Sridharan & Thizy 1991; generator of Gasse
et al. 2019 at its published 100 x 100 default), and checks every answer
against scipy's HiGHS.  It also measures the card's matmul precision and
checks the double-float EFT arithmetic on the card.

Usage::

    python chip_smoke.py                # one card, all phases
    python chip_smoke.py --four-cards   # the column-sharded path on 4 cards

Each phase prints its result and its seconds.  The last line of standard
output is one JSON object, ``{"ok": ..., "device": {...}}``; any failed
phase makes ``ok`` false and the exit code 1.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
from fractions import Fraction

# Main LP: the generator's published default size.
MAIN_CUSTOMERS, MAIN_FACILITIES, MAIN_SEED = 100, 100, 0
# Scenario batch: B perturbed-demand copies of a smaller base instance.
BATCH_SIZE, BATCH_CUSTOMERS, BATCH_FACILITIES, BATCH_SEED = 64, 20, 20, 1
# MIP: integer y on a small instance (exact branch and bound).
MIP_CUSTOMERS, MIP_FACILITIES, MIP_SEED = 10, 8, 3

_failed: list = []
_compile = {"seconds": 0.0, "compiles": 0, "cache_hits": 0}


def _listen_compiles() -> None:
    import jax.monitoring as mon

    def on_duration(event, duration, **_kw):
        if event == "/jax/core/compile/backend_compile_duration":
            _compile["seconds"] += duration
            _compile["compiles"] += 1

    def on_event(event, **_kw):
        if event == "/jax/compilation_cache/cache_hits":
            _compile["cache_hits"] += 1

    mon.register_event_duration_secs_listener(on_duration)
    mon.register_event_listener(on_event)


@contextlib.contextmanager
def phase(name: str):
    """Run one phase: print its outcome, seconds and compile seconds."""
    t0 = time.time()
    c0 = dict(_compile)
    print(f"== {name}", flush=True)
    try:
        yield
    except Exception:  # noqa: BLE001 — reported, and fails the run below
        traceback.print_exc(file=sys.stdout)
        _failed.append(name)
        outcome = "FAILED"
    else:
        outcome = "ok"
    print(
        f"== {name}: {outcome} in {time.time() - t0:.3f} s "
        f"(compile {_compile['seconds'] - c0['seconds']:.3f} s in "
        f"{_compile['compiles'] - c0['compiles']} compiles, "
        f"{_compile['cache_hits'] - c0['cache_hits']} persistent-cache hits)",
        flush=True,
    )


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _cli(argv):
    """``python -m relp_tpu ...`` in this process; returns (rc, stdout)."""
    from relp_tpu.__main__ import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _cli_json(argv):
    """``_cli`` for ``--json`` runs: (rc, the JSON object printed last)."""
    rc, out = _cli(argv)
    return rc, json.loads(out.strip().splitlines()[-1])


def _agrees(value: float, ref: float) -> bool:
    """HiGHS stops at a 1e-7 feasibility tolerance; 1e-6 relative covers it."""
    return abs(value - ref) <= 1e-6 * max(1.0, abs(ref))


def _write_mps(inst, path: str, *, integer_y: bool = False) -> str:
    from relp_tpu.data import facility

    with open(path, "w") as f:
        f.write(facility.to_mps(inst, integer_y=integer_y))
    return path


def require_gpu():
    """The platform check: refuses anything but a GPU backend."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX backend is {devices[0].platform!r} ({devices})"
        )
    return devices


def phase_device() -> None:
    import jax

    print(f"jax {jax.__version__}; devices: {jax.devices()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    for line in smi:
        print(line)
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")


def phase_native() -> None:
    from relp_tpu.exact.dixon import _load_modp
    from relp_tpu.io.native import native_available

    check(native_available(), "native MPS parser did not build or load")
    check(_load_modp() is not None, "native mod-p library did not build or load")
    print("native: libmps_parser.so and libmodp.so loaded")


def phase_main_lp(workdir: str) -> tuple:
    """Returns the padded (M, N) the LP was solved at."""
    from relp_tpu.data import facility

    inst = facility.generate(MAIN_CUSTOMERS, MAIN_FACILITIES, seed=MAIN_SEED)
    path = _write_mps(inst, os.path.join(workdir, "cfl_main.mps"))
    cert = os.path.join(workdir, "cfl_main.cert.json")
    print(
        f"instance: capacitated facility location {MAIN_CUSTOMERS} customers "
        f"x {MAIN_FACILITIES} facilities, seed {MAIN_SEED}"
    )
    t0 = time.time()
    highs = facility.highs_objective(inst)
    print(f"HiGHS reference objective {highs!r} in {time.time() - t0:.3f} s")

    t0 = time.time()
    rc, res = _cli_json(["solve", path, "--json", "--certificate", cert])
    wall = time.time() - t0
    st = res["stats"]
    M, N = st["device_shape"]
    print(
        f"M={M} N={N} tableau f32 {M * N * 4 / 1e9:.3f} GB, "
        f"B^-1 f32 {M * M * 4 / 1e9:.3f} GB on the device"
    )
    print(
        f"status={res['status']} certified={res['certified']} "
        f"objective={res['objective_float']!r} (exact {res['objective']})"
    )
    print(
        f"pivots={res['iterations']} (phase 1: {res['phase1_iterations']}) "
        f"chunks={st['chunks']} refactorizations={st['refactorizations']} "
        f"host_lapack_refactors={st['host_refactors']} "
        f"escalations={st['escalations']} "
        f"exact_cleanup_pivots={st['exact_cleanup_pivots']}"
    )
    dev_s = res["wall_time_s"] - st["certify_time_s"]
    print(
        f"solve wall {res['wall_time_s']:.3f} s: device+host loop {dev_s:.3f} s, "
        f"exact certify {st['certify_time_s']:.3f} s; CLI total {wall:.3f} s"
    )
    if st["escalations"] or st["host_refactors"]:
        print(
            "FINDING: escalations or host-LAPACK refactors on the main LP "
            f"(escalations={st['escalations']}, "
            f"host_refactors={st['host_refactors']})"
        )
    check(rc == 0 and res["status"] == "finite_optimum", f"status {res}")
    check(res["certified"] is True, "main LP not exactly certified")
    check(highs is not None, "HiGHS found no optimum")
    check(
        _agrees(res["objective_float"], highs),
        f"objective {res['objective_float']!r} vs HiGHS {highs!r}",
    )
    t0 = time.time()
    rc, out = _cli(["verify", path, cert])
    print(f"verify: {out.strip()} ({time.time() - t0:.3f} s)")
    check(rc == 0 and out.startswith("VERIFIED"), "certificate not verified")
    return M, N


def _scenario_providers(insts):
    """Standard-form providers, without presolve: every scenario keeps the
    base instance's rows and columns, so one basis indexes them all."""
    from relp_tpu.data import facility

    providers = []
    for inst in insts:
        gf = facility.general_form(inst)
        providers.append(gf.derive_matrix_data(gf.standardize()))
    return providers


def phase_batch() -> None:
    import numpy as np

    from relp_tpu.config import SolverConfig
    from relp_tpu.data import facility
    from relp_tpu.parallel.batch_driver import solve_batch
    from relp_tpu.simplex import solve_relaxation

    base = facility.generate(BATCH_CUSTOMERS, BATCH_FACILITIES, seed=BATCH_SEED)
    rng = np.random.default_rng(BATCH_SEED)
    # Each customer's demand scaled by a seeded 80-120 %.
    insts = [
        facility.with_demand_scale(
            base, rng.integers(80, 121, size=base.n_customers)
        )
        for _ in range(BATCH_SIZE)
    ]
    cfg = SolverConfig()
    t0 = time.time()
    base_res = solve_relaxation(_scenario_providers([base])[0], cfg)
    check(base_res.stats.certified, "base instance not certified")
    print(f"base LP certified in {time.time() - t0:.3f} s")
    providers = _scenario_providers(insts)
    t0 = time.time()
    results = solve_batch(
        providers, cfg, shared_structure=True, warm_start_basis=base_res.basis
    )
    wall = time.time() - t0
    t0 = time.time()
    highs = [facility.highs_objective(inst) for inst in insts]
    t_highs = time.time() - t0
    certified = sum(r.stats.certified for r in results)
    fallback = sum(r.stats.batch_fallback for r in results)
    dual = sum(r.stats.dual_iterations for r in results)
    pivots = sum(r.stats.iterations for r in results)
    # Warm-started scenarios skip phase 1; fallbacks re-solve from scratch.
    phase1 = sum(
        r.stats.phase1_iterations for r in results if not r.stats.batch_fallback
    )
    agree = sum(
        r.exact_objective is not None
        and h is not None
        and _agrees(float(r.exact_objective), h)
        for r, h in zip(results, highs)
    )
    print(
        f"B={BATCH_SIZE} x {BATCH_CUSTOMERS}x{BATCH_FACILITIES} facility "
        f"location: certified {certified}/{BATCH_SIZE}, HiGHS agreement "
        f"{agree}/{BATCH_SIZE}, batch_fallback {fallback}, dual warm-restart "
        f"pivots {dual}, primal pivots {pivots} (phase 1 outside "
        f"fallbacks: {phase1}); "
        f"solve_batch {wall:.3f} s, "
        f"HiGHS {t_highs:.3f} s"
    )
    check(certified == BATCH_SIZE, "uncertified scenarios")
    check(agree == BATCH_SIZE, "scenarios disagree with HiGHS")
    check(phase1 == 0, "warm restart did not engage (phase-1 pivots ran)")


def phase_mip(workdir: str) -> None:
    import numpy as np
    from scipy.optimize import Bounds, LinearConstraint, milp

    from relp_tpu.data import facility

    inst = facility.generate(MIP_CUSTOMERS, MIP_FACILITIES, seed=MIP_SEED)
    path = _write_mps(inst, os.path.join(workdir, "cfl_mip.mps"), integer_y=True)
    rc, res = _cli_json(["solve", "--mip", "--json", path])
    c, A, b, _ = facility.linprog_data(inst)
    integrality = np.zeros(c.shape[0])
    integrality[-inst.n_facilities:] = 1
    ref = milp(
        c, constraints=LinearConstraint(A, -np.inf, b),
        bounds=Bounds(0, 1), integrality=integrality,
    )
    print(
        f"MIP {MIP_CUSTOMERS}x{MIP_FACILITIES}: status={res['status']} "
        f"certified={res['certified']} interval=[{res['best_bound']}, "
        f"{res['objective']}] nodes={res['nodes_solved']}; scipy milp "
        f"{ref.fun!r}"
    )
    check(rc == 0 and res["certified"], f"MIP not certified: {res}")
    lo, hi = float(Fraction(res["best_bound"])), float(Fraction(res["objective"]))
    tol = 1e-6 * max(1.0, abs(ref.fun))
    check(lo - tol <= ref.fun <= hi + tol, "milp optimum outside the interval")


def phase_first_order(workdir: str) -> None:
    from relp_tpu.data import facility

    inst = facility.generate(BATCH_CUSTOMERS, BATCH_FACILITIES, seed=BATCH_SEED)
    path = _write_mps(inst, os.path.join(workdir, "cfl_fo.mps"))
    rc_s, simplex = _cli_json(["solve", "--json", path])
    rc_f, first = _cli_json(["solve", "--first-order", "--json", path])
    print(
        f"first-order {BATCH_CUSTOMERS}x{BATCH_FACILITIES}: status="
        f"{first['status']} certified={first['certified']} objective "
        f"{first['objective']}; simplex {simplex['objective']}"
    )
    check(rc_s == 0 and simplex["certified"], "simplex path not certified")
    check(rc_f == 0 and first["certified"], "first-order path not certified")
    check(first["objective"] == simplex["objective"], "exact objectives differ")


def _rel_errors(got, ref, P, A):
    """(max |err| / max |ref|, max_ij |err_ij| / (|P_i| |A_j|))."""
    import numpy as np

    err = np.abs(np.asarray(got, np.float64) - ref)
    norms = np.outer(np.linalg.norm(P, axis=-1), np.linalg.norm(A, axis=0))
    return float(err.max() / np.abs(ref).max()), float((err / norms).max())


def phase_precision(main_shape) -> None:
    """Default-precision and HIGHEST f32 products against f64 numpy, at the
    bench shape and at the main LP's padded (M, N) when it ran."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from relp_tpu.backend import backend_facts

    HI = jax.lax.Precision.HIGHEST
    eps = backend_facts().scan_noise_eps
    key = jax.random.PRNGKey(0)
    cols = 4096  # reference columns compared (every column's error is alike)
    worst_default = 0.0
    shapes = [("bench", (1024, 5120))] + ([("main", main_shape)] if main_shape else [])
    for label, (M, N) in shapes:
        k1, k2, k3, k4 = jax.random.split(jax.random.fold_in(key, M), 4)
        A = jax.random.normal(k1, (M, N), jnp.float32)
        P = jax.random.normal(k2, (3, M), jnp.float32)
        A_h = np.asarray(A[:, :cols], np.float64)
        P_h = np.asarray(P, np.float64)
        ref = P_h @ A_h
        tol_hi = 4 * math.sqrt(M) * 2.0**-24
        for name, prec in (("default", None), ("HIGHEST", HI)):
            S = jax.jit(lambda p, a, prec=prec: jnp.matmul(p, a, precision=prec))(P, A)
            scale_err, norm_err = _rel_errors(S[:, :cols], ref, P_h, A_h)
            print(
                f"[{label} M={M} N={N}] stacked (3,M)@(M,N) {name}: max err "
                f"/ max|ref| {scale_err:.3e}; / row norms {norm_err:.3e}"
            )
            if prec is None:
                worst_default = max(worst_default, scale_err)
            else:
                check(norm_err <= tol_hi, f"HIGHEST {norm_err} > {tol_hi}")
        v = jax.jit(lambda p, a: p @ a)(P[0], A)
        scale_err, norm_err = _rel_errors(v[None, :cols], ref[:1], P_h[:1], A_h)
        print(f"[{label}] matvec (M,)@(M,N) default: max err / max|ref| {scale_err:.3e}")
        worst_default = max(worst_default, scale_err)
        # The FTRAN / refactorization products: (M,M)@(M,) and (M,M)@(M,M).
        Bm = jax.random.normal(k3, (M, M), jnp.float32)
        X = jax.random.normal(k4, (M, 256), jnp.float32)
        B_h = np.asarray(Bm, np.float64)
        X_h = np.asarray(X, np.float64)
        ref_bx = B_h @ X_h
        bx = jax.jit(lambda b, x: jnp.matmul(b, x, precision=HI))(Bm, X)
        _, norm_err = _rel_errors(bx, ref_bx, B_h, X_h)
        w = jax.jit(lambda b, x: jnp.matmul(b, x, precision=HI))(Bm, X[:, 0])
        _, norm_w = _rel_errors(w[:, None], ref_bx[:, :1], B_h, X_h[:, :1])
        print(
            f"[{label}] HIGHEST (M,M)@(M,256) {norm_err:.3e}, FTRAN "
            f"(M,M)@(M,) {norm_w:.3e} / row norms; tolerance "
            f"4 sqrt(M) 2^-24 = {tol_hi:.3e}"
        )
        check(max(norm_err, norm_w) <= tol_hi, "HIGHEST product out of tolerance")
        del A, Bm
    # Batched einsum of the scenario driver, at the bench shape.
    Bsz, M, N = 64, 1024, 5120
    k1, k2 = jax.random.split(jax.random.fold_in(key, 7))
    Ab = jax.random.normal(k1, (Bsz, M, N), jnp.float32)
    pb = jax.random.normal(k2, (Bsz, M), jnp.float32)
    ref = np.einsum(
        "bm,bmn->bn", np.asarray(pb[:4], np.float64),
        np.asarray(Ab[:4, :, :cols], np.float64),
    )
    out = jax.jit(lambda p, a: jnp.einsum("bm,bmn->bn", p, a))(pb, Ab)
    got = np.asarray(out[:4, :cols], np.float64)
    scale_err = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"[bench B=64] batched einsum default: max err / max|ref| {scale_err:.3e}")
    worst_default = max(worst_default, scale_err)
    print(
        f"worst default-precision error {worst_default:.3e}; backend table "
        f"scan_noise_eps {eps:.3e}"
    )
    check(worst_default <= eps, "default-precision error above the table's floor")


def phase_eft() -> None:
    """tests/test_df32.py::test_eft_exactness_under_jit, on the card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from relp_tpu.ops.df32 import two_prod, two_sum

    n = 1 << 20
    a = jax.random.normal(jax.random.PRNGKey(0), (n,), jnp.float32) * 1e3
    b = jax.random.normal(jax.random.PRNGKey(1), (n,), jnp.float32)
    a64 = np.asarray(a, np.float64)
    b64 = np.asarray(b, np.float64)
    s, e = jax.jit(two_sum)(a, b)
    bad_sum = int(np.sum(np.asarray(s, np.float64) + np.asarray(e, np.float64) != a64 + b64))
    p, pe = jax.jit(two_prod)(a, b)
    bad_prod = int(np.sum(np.asarray(p, np.float64) + np.asarray(pe, np.float64) != a64 * b64))
    print(f"EFT on {n} pairs: two_sum inexact {bad_sum}, two_prod inexact {bad_prod}")
    check(bad_sum == 0 and bad_prod == 0, "EFT not exact on the card")


def phase_warm_compile() -> None:
    """Drop the in-memory executables and solve a small LP again: what the
    persistent cache serves shows as hits instead of compile seconds."""
    import jax

    from relp_tpu.config import SolverConfig
    from relp_tpu.data import facility
    from relp_tpu.simplex import solve_relaxation

    prov = _scenario_providers(
        [facility.generate(BATCH_CUSTOMERS, BATCH_FACILITIES, seed=BATCH_SEED)]
    )[0]
    cold0 = dict(_compile)
    solve_relaxation(prov, SolverConfig())  # shapes already compiled: no work
    jax.clear_caches()
    warm0 = dict(_compile)
    res = solve_relaxation(prov, SolverConfig())
    print(
        f"after jax.clear_caches(): compile {_compile['seconds'] - warm0['seconds']:.3f} s "
        f"in {_compile['compiles'] - warm0['compiles']} compiles, "
        f"{_compile['cache_hits'] - warm0['cache_hits']} persistent-cache hits "
        f"(in-memory rerun before it: {_compile['compiles'] - cold0['compiles']} "
        f"compiles); whole run so far {_compile['seconds']:.3f} s of compile"
    )
    check(res.stats.certified, "rerun not certified")


def phase_four_cards() -> None:
    import __graft_entry__

    __graft_entry__.dryrun_multichip(4, report=print)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the column-sharded / batch x col path on 4 cards",
    )
    args = parser.parse_args(argv)
    device = {"platform": None, "kind": None, "count": 0}
    try:
        devices = require_gpu()
        device = {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        }
        from relp_tpu.utils.cache import enable_compilation_cache

        _listen_compiles()
        print(f"compilation cache: {enable_compilation_cache()}")
    except Exception:  # noqa: BLE001 — reported as ok: false below
        traceback.print_exc(file=sys.stdout)
        _failed.append("device")
    if not _failed:
        with phase("device"):
            phase_device()
        if args.four_cards:
            with phase("four cards"):
                check(len(devices) >= 4, f"need 4 cards, have {len(devices)}")
                phase_four_cards()
        else:
            with tempfile.TemporaryDirectory() as workdir:
                with phase("native"):
                    phase_native()
                main_shape = None
                with phase("main LP"):
                    main_shape = phase_main_lp(workdir)
                with phase("scenario batch"):
                    phase_batch()
                with phase("MIP"):
                    phase_mip(workdir)
                with phase("first-order"):
                    phase_first_order(workdir)
                with phase("precision"):
                    phase_precision(main_shape)
                with phase("df32 EFT"):
                    phase_eft()
                with phase("warm compile"):
                    phase_warm_compile()
    ok = not _failed
    if _failed:
        print(f"failed phases: {_failed}")
    print(json.dumps({"ok": ok, "device": device}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
