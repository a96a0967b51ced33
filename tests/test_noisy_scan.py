"""Noisy-scan (inexact default-precision f32 matmul) termination semantics.

On the GPU, default-precision f32 matmuls may run in TF32, so
"same-precision" f32 pricing scans carry noise (relp_tpu.backend,
``scan_noise_eps``).  The guarded-scan machinery (kernels.make_iteration
``noise_eps``, the drivers' zero-pivot OPTIMAL acceptance rule) keeps
pricing from livelocking on phantom reduced costs.  CPU matmuls are exact,
so these tests switch the guards on by patching the backend-facts table:
the guard logic must stay *correct* (same verdicts, exactly certified
objectives) when enabled on a clean backend — the noise floor may hide
small candidates mid-chunk, and the chunk-boundary clean arbiter must
recover every one of them.
"""

import dataclasses

import numpy as np
import pytest

from relp_tpu import backend
from relp_tpu.config import SolverConfig
from relp_tpu.data import facility
from relp_tpu.simplex import SolveStatus, solve_general_form


@pytest.fixture
def force_noisy(monkeypatch):
    monkeypatch.setitem(
        backend._FACTS,
        "cpu",
        dataclasses.replace(backend._FACTS["cpu"], scan_noise_eps=4e-3),
    )


def test_noisy_scan_single_lp(force_noisy):
    """The single-LP driver under forced-noisy semantics: the scaled
    eligibility floor + pick recheck + zero-pivot OPTIMAL acceptance must
    still reach the exact certified optimum."""
    inst = facility.generate(8, 8, seed=4)
    cfg = SolverConfig(pad_to=8, chunk_size=50, refactor_period=50)
    result, solution = solve_general_form(facility.general_form(inst), cfg)
    assert result.status is SolveStatus.FINITE_OPTIMUM
    assert result.stats.certified
    highs = facility.highs_objective(inst)
    assert abs(float(solution.objective_value) - highs) <= 1e-6 * abs(highs)


def test_noisy_scan_batch_driver(force_noisy):
    """The scenario batch driver re-arms falsely-OPTIMAL LPs at the clean
    chunk boundary instead of accepting scan-noise freezes; every scenario
    must come back exactly certified and equal to HiGHS."""
    from relp_tpu.parallel.batch_driver import solve_batch

    base = facility.generate(6, 6, seed=5)
    rng = np.random.default_rng(5)
    insts = [
        facility.with_demand_scale(base, rng.integers(80, 121, size=6))
        for _ in range(3)
    ]
    providers = []
    for inst in insts:
        gf = facility.general_form(inst)
        providers.append(gf.derive_matrix_data(gf.standardize()))

    cfg = SolverConfig(pad_to=32, chunk_size=50, refactor_period=50)
    results = solve_batch(providers, cfg, certify=True, shared_structure=True)
    for r, inst in zip(results, insts):
        assert r.status is SolveStatus.FINITE_OPTIMUM
        assert r.stats.certified
        highs = facility.highs_objective(inst)
        assert abs(float(r.exact_objective) - highs) <= 1e-6 * abs(highs)
