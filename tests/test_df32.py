"""Double-float (two-f32) carry: EFT exactness, compensated linalg accuracy,
and the escalation rung that rescues drift-prone LPs at f32 speed.

Reference anchor: the carry the reference maintains *exactly* in rationals
(inverse_maintenance/carry/mod.rs:46-66).  The df32 engine reproduces
f64-grade carry accuracy with native f32 ops (relp_tpu/ops/df32,
relp_tpu/simplex/df_kernels); correctness still terminates in the exact
rational certifier, like every other float path.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from relp_tpu.ops.df32 import (
    df_dot,
    df_div,
    df_from_f64,
    df_matvec,
    df_to_f64,
    df_vecmat,
    two_prod,
    two_sum,
)

RUN_SLOW = bool(os.environ.get("RELP_TPU_RUN_SLOW"))


def test_eft_exactness_under_jit():
    """two_sum/two_prod must be *exact* after XLA compilation: hi + lo
    (evaluated in f64) equals the true sum/product of the f32 inputs.
    XLA must not algebraically simplify the EFT cancellation patterns."""
    key = jax.random.PRNGKey(0)
    a = jax.random.normal(key, (4096,), jnp.float32) * 1e3
    b = jax.random.normal(jax.random.PRNGKey(1), (4096,), jnp.float32)

    s, e = jax.jit(two_sum)(a, b)
    exact = np.float64(np.asarray(a)) + np.float64(np.asarray(b))
    got = np.float64(np.asarray(s)) + np.float64(np.asarray(e))
    np.testing.assert_array_equal(got, exact)

    p, pe = jax.jit(two_prod)(a, b)
    exact = np.float64(np.asarray(a)) * np.float64(np.asarray(b))
    got = np.float64(np.asarray(p)) + np.float64(np.asarray(pe))
    np.testing.assert_array_equal(got, exact)


def test_df_matvec_accuracy_vs_f32():
    """On an ill-conditioned matrix the compensated matvec must be ~f64
    accurate while the plain f32 matvec loses most of its digits."""
    rng = np.random.default_rng(7)
    m = 200
    # Hilbert-flavored + random: condition number ~1e8.
    i = np.arange(m)
    H = 1.0 / (1.0 + i[:, None] + i[None, :])
    M64 = H + 1e-4 * rng.standard_normal((m, m))
    X64 = np.linalg.inv(M64)  # the ill-conditioned operand
    v64 = rng.standard_normal(m)

    exact = X64 @ v64
    scale = np.max(np.abs(exact))

    f32_err = np.max(
        np.abs(np.asarray(
            jnp.asarray(X64, jnp.float32) @ jnp.asarray(v64, jnp.float32)
        ) - exact)
    )
    Xh, Xl = df_from_f64(X64)
    vh, vl = df_from_f64(v64)
    wh, wl = jax.jit(df_matvec)(Xh, Xl, vh, vl)
    df_err = np.max(np.abs(df_to_f64(wh, wl) - exact))

    assert df_err < 1e-9 * scale, df_err
    assert df_err < 1e-4 * f32_err  # >=4 orders of magnitude better


def test_df_vecmat_dot_div():
    rng = np.random.default_rng(3)
    m = 157  # odd size exercises the pairwise-reduction padding
    M64 = rng.standard_normal((m, m)) * 10.0
    v64 = rng.standard_normal(m)
    Mh, Ml = df_from_f64(M64)
    vh, vl = df_from_f64(v64)

    # df accuracy is ~2^-47 relative to the *summand* magnitudes, so entries
    # that cancel to near zero need an absolute tolerance.
    rh, rl = jax.jit(df_vecmat)(vh, vl, Mh, Ml)
    np.testing.assert_allclose(
        df_to_f64(rh, rl), v64 @ M64, rtol=1e-11, atol=1e-10
    )

    u64 = rng.standard_normal(m)
    uh, ul = df_from_f64(u64)
    dh, dl = jax.jit(df_dot)(vh, vl, uh, ul)
    np.testing.assert_allclose(
        float(df_to_f64(dh, dl)), float(v64 @ u64), rtol=1e-12
    )

    qh, ql = jax.jit(df_div)(vh, vl, uh, ul)
    np.testing.assert_allclose(df_to_f64(qh, ql), v64 / u64, rtol=1e-11)


def _solve_netlib_df32(name, **overrides):
    from relp_tpu.config import SolverConfig
    from relp_tpu.io import mps_to_general_form, parse_fixed
    from relp_tpu.simplex import solve_general_form

    from conftest import reference_problem

    path = reference_problem("netlib", f"{name}.SIF")
    with open(path) as f:
        gf = mps_to_general_form(parse_fixed(f.read()))
    cfg = SolverConfig(
        dtype="float32", carry="df32", pad_to=64, chunk_size=100,
        refactor_period=100, **overrides,
    )
    return solve_general_form(gf, cfg)


def test_df32_solves_afiro_certified():
    from relp_tpu.simplex import SolveStatus

    result, solution = _solve_netlib_df32("AFIRO")
    assert result.status is SolveStatus.FINITE_OPTIMUM
    assert result.stats.certified
    assert abs(float(solution.objective_value) + 464.75314286) < 1e-4


@pytest.mark.skipif(not RUN_SLOW, reason="~20 s; set RELP_TPU_RUN_SLOW=1")
def test_df32_rescues_grow7_without_f64():
    """GROW7 breaks the plain-f32 path (drift-induced singular basis); the
    df32 carry must solve and exactly certify it with no f64 retry."""
    from relp_tpu.simplex import SolveStatus

    result, solution = _solve_netlib_df32("GROW7")
    assert result.status is SolveStatus.FINITE_OPTIMUM
    assert result.stats.certified
    assert result.stats.escalations == []  # df32 itself, no further rungs
    assert abs(float(solution.objective_value) + 47787811.8147115) < 1e-1


def _ladder_run(monkeypatch, f64_native: bool):
    """Force the first (f32) attempt to report NUMERICAL_ERROR so the
    escalation ladder runs on a small facility location LP; return the
    rungs tried (in order) and the final result."""
    import dataclasses

    from relp_tpu import backend
    from relp_tpu.config import SolverConfig
    from relp_tpu.data import facility
    from relp_tpu.simplex import driver as driver_mod
    from relp_tpu.simplex.result import OptimizationResult, SolveStats
    from relp_tpu.simplex.result import SolveStatus

    monkeypatch.setitem(
        backend._FACTS,
        "cpu",
        dataclasses.replace(backend._FACTS["cpu"], f64_native=f64_native),
    )
    calls = []
    real_once = driver_mod._solve_relaxation_once

    def failing_then_real(provider, config=None, warm_start_basis=None,
                          mesh=None):
        calls.append("df32" if config.carry == "df32" else config.dtype)
        if len(calls) == 1:
            return OptimizationResult(
                status=SolveStatus.NUMERICAL_ERROR, stats=SolveStats()
            )
        return real_once(provider, config, warm_start_basis, mesh)

    monkeypatch.setattr(
        driver_mod, "_solve_relaxation_once", failing_then_real
    )
    gf = facility.general_form(facility.generate(5, 5, seed=0))
    gf.presolve()
    md = gf.derive_matrix_data(gf.standardize())
    result = driver_mod.solve_relaxation(md, SolverConfig(dtype="float32", pad_to=64))
    assert result.status is SolveStatus.FINITE_OPTIMUM
    assert result.stats.certified
    return calls, result


def test_escalation_ladder_prefers_df32_when_f64_emulated(monkeypatch):
    """Where f64 is not native, an f32 solve that fails numerically must
    retry via the df32 rung before any f64 attempt, and record the rungs."""
    calls, result = _ladder_run(monkeypatch, f64_native=False)
    assert calls[:2] == ["float32", "df32"]
    assert result.stats.escalations == ["df32"]


def test_escalation_ladder_skips_df32_when_f64_native(monkeypatch):
    """Where f64 is native (CPU, GPU), the ladder goes straight from f32 to
    f64; df32 stays a carry a user can pick."""
    calls, result = _ladder_run(monkeypatch, f64_native=True)
    assert calls[:2] == ["float32", "float64"]
    assert "df32" not in calls
    assert result.stats.escalations == ["float64"]
