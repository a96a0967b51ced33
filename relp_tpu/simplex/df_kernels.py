"""Double-float (two-f32) simplex carry kernels.

A carry between the f32 fast path and f64: on backends without native f64
it is the escalation ladder's middle rung (relp_tpu.backend), elsewhere a
rung a user can pick (``SolverConfig(carry="df32")``).  The carry (B^-1, x_B, pi, obj — the state the reference
maintains exactly in rationals, carry/mod.rs:46-66) is held as hi/lo f32
pairs and updated with compensated arithmetic (relp_tpu/ops/df32), so both
drift *and* matvec-accumulation error stay at ~2^-48 while every op runs in
native f32.  Problem data is lowered in f64 and split hi/lo,
so data accuracy matches the carry.

What stays plain f32: the full-width pricing/steepest-edge scans (noise is
guarded by the per-column accurate recheck, exactly like the mixed f64+f32
mode in kernels.make_iteration) and the gamma weights (pricing quality
only).  What cannot be double-float: dense refactorization (a compensated
Newton-Schulz step would need O(m^3) compensated accumulation), so the df
engine refactorizes on the host in f64 and splits the result.

The iteration structure mirrors kernels.make_iteration exactly (pricing ->
FTRAN -> Harris ratio test -> rank-1 product-form update -> Goldfarb gamma
scan); reference anchors are cited there.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from relp_tpu.ops.df32 import (
    df_add,
    df_div,
    df_dot,
    df_matvec,
    df_mul,
    df_mul_f,
    df_sub,
    df_vecmat,
    two_prod,
)
from relp_tpu.simplex.kernels import (
    PRICE_STEEPEST,
    _select_entering,
    _select_leaving,
)
from relp_tpu.simplex.state import OPTIMAL, RUNNING, UNBOUNDED


class DfMatrix(NamedTuple):
    """A matrix split as an unevaluated f32 sum ``hi + lo`` (from f64)."""

    hi: jax.Array
    lo: jax.Array


class DfVec(NamedTuple):
    hi: jax.Array
    lo: jax.Array


class DfSimplexState(NamedTuple):
    """Simplex state with a double-float carry.

    Field names for the hi parts match ``SimplexState`` so the driver's
    status/obj/xB/basis accesses work unchanged; ``*_lo`` holds the
    compensation terms.
    """

    Binv: jax.Array
    Binv_lo: jax.Array
    basis: jax.Array
    xB: jax.Array
    xB_lo: jax.Array
    pi: jax.Array
    pi_lo: jax.Array
    obj: jax.Array
    obj_lo: jax.Array
    in_basis: jax.Array
    gamma: jax.Array
    iteration: jax.Array
    status: jax.Array
    degen_count: jax.Array
    inner: jax.Array
    price_start: jax.Array
    d: jax.Array


def make_df_iteration(
    pricing: int, opt_tol, pivot_tol, degen_tol,
    noise_eps: float = 0.0, hi_scan: bool = False,
):
    """One fused df32 simplex iteration (see kernels.make_iteration).

    ``noise_eps``/``hi_scan`` follow kernels.make_iteration: with
    ``noise_eps > 0`` the default-precision f32 scans are inexact (noise
    floor scaled accordingly, chunk-entry iteration exempt — its d comes
    from a clean matvec refresh); hi_scan is the polish mode
    (HIGHEST-precision scans).
    """
    from relp_tpu.simplex.kernels import _HI

    scan_precision = _HI if hi_scan else None
    noisy = noise_eps > 0 and not hi_scan

    def iteration(state, A_scan, Ah, Al, ch, cl, c_scan, candidate_mask):
        M, N = A_scan.shape

        # --- pricing on the f32 scan copy; eligibility guarded against scan
        # noise exactly like the mixed-precision path ---
        d = state.d
        noise = noise_eps if noisy else float(jnp.finfo(jnp.float32).eps) * 8.0
        threshold = opt_tol + noise * (1.0 + jnp.max(jnp.abs(state.pi)))
        if noisy:
            # Chunk-entry d comes from an exact matvec refresh: price it
            # with the plain floor so sub-noise candidates still pivot.
            threshold = jnp.where(
                state.inner == 0, jnp.asarray(opt_tol, jnp.float32), threshold
            )
        eligible = candidate_mask & (~state.in_basis) & (d < -threshold)
        q, any_eligible = _select_entering(
            d, state.gamma, eligible, pricing, N, start=state.price_start
        )
        q = q.astype(jnp.int32)

        # --- FTRAN, compensated: w = B^-1 a_q at ~2^-48 ---
        a_qh, a_ql = Ah[:, q], Al[:, q]
        wh, wl = df_matvec(state.Binv, state.Binv_lo, a_qh, a_ql)

        # Accurate reduced cost of the selected column; scan-noise
        # candidates terminate the chunk (driver + certifier decide).
        sh, sl = df_dot(state.pi, state.pi_lo, a_qh, a_ql)
        dqh, dql = df_sub(ch[q], cl[q], sh, sl)
        any_eligible = any_eligible & (dqh < -opt_tol)

        # --- ratio test on the (accurate) hi parts ---
        r, any_positive = _select_leaving(
            state.xB, wh, state.basis, pricing, pivot_tol, M
        )

        new_status = jnp.where(
            ~any_eligible,
            OPTIMAL,
            jnp.where(~any_positive, UNBOUNDED, RUNNING),
        ).astype(jnp.int32)
        do_pivot = new_status == RUNNING

        # --- basis change: rank-1 product-form update in df ---
        w_rh, w_rl = wh[r], wl[r]
        safe_wrh = jnp.where(do_pivot, w_rh, 1.0)
        safe_wrl = jnp.where(do_pivot, w_rl, 0.0)
        pos_r = state.xB[r] > 0.0
        xrh = jnp.where(pos_r, state.xB[r], 0.0)
        xrl = jnp.where(pos_r, state.xB_lo[r], 0.0)
        th, tl = df_div(xrh, xrl, safe_wrh, safe_wrl)
        beta_h, beta_l = df_div(
            state.Binv[r], state.Binv_lo[r], safe_wrh, safe_wrl
        )

        # Binv - outer(w, beta), keeping first-order compensation terms.
        ph, pe = two_prod(wh[:, None], beta_h[None, :])
        pe = pe + (wh[:, None] * beta_l[None, :] + wl[:, None] * beta_h[None, :])
        Bh_new, Bl_new = df_sub(state.Binv, state.Binv_lo, ph, pe)
        Bh_new = Bh_new.at[r].set(beta_h)
        Bl_new = Bl_new.at[r].set(beta_l)

        xh_step, xl_step = df_mul(th, tl, wh, wl)
        xBh_new, xBl_new = df_sub(state.xB, state.xB_lo, xh_step, xl_step)
        xBh_new = xBh_new.at[r].set(th)
        xBl_new = xBl_new.at[r].set(tl)

        leaving = state.basis[r]
        basis_new = state.basis.at[r].set(q)
        in_basis_new = state.in_basis.at[leaving].set(False).at[q].set(True)

        # pi' = pi + d_q * beta (incremental dual update, df).
        dh, de = df_mul(dqh, dql, beta_h, beta_l)
        pih_new, pil_new = df_add(state.pi, state.pi_lo, dh, de)

        # obj = c_B @ x_B, compensated (phase-1 stop_at_zero reads obj).
        cBh, cBl = ch[basis_new], cl[basis_new]
        objh_new, objl_new = df_dot(cBh, cBl, xBh_new, xBl_new)

        # --- f32 scans: next reduced costs + Goldfarb gamma update ---
        if pricing == PRICE_STEEPEST:
            gamma_q_val = 1.0 + wh @ wh
            v = wh @ state.Binv  # work vector, OLD inverse (f32)
            P = jnp.stack([pih_new, v, beta_h])
            S = jnp.matmul(P, A_scan, precision=scan_precision)
            d_next = c_scan - S[0]
            inner = S[1]
            abar = S[2]
            gamma_new = (
                state.gamma - 2.0 * abar * inner + (abar * abar) * gamma_q_val
            )
            gamma_new = jnp.maximum(gamma_new, 1.0 + abar * abar)
            gamma_new = gamma_new.at[leaving].set(
                jnp.maximum(gamma_q_val / (safe_wrh * safe_wrh), 1.0)
            )
            gamma_new = gamma_new.at[q].set(1.0)
        else:
            gamma_new = state.gamma
            d_next = c_scan - jnp.matmul(
                pih_new, A_scan, precision=scan_precision
            )

        degenerate = th <= degen_tol
        degen_new = jnp.where(degenerate, state.degen_count + 1, 0).astype(
            jnp.int32
        )

        select = lambda new, old: jnp.where(do_pivot, new, old)
        return DfSimplexState(
            Binv=select(Bh_new, state.Binv),
            Binv_lo=select(Bl_new, state.Binv_lo),
            basis=select(basis_new, state.basis),
            xB=select(xBh_new, state.xB),
            xB_lo=select(xBl_new, state.xB_lo),
            pi=select(pih_new, state.pi),
            pi_lo=select(pil_new, state.pi_lo),
            obj=select(objh_new, state.obj),
            obj_lo=select(objl_new, state.obj_lo),
            in_basis=select(in_basis_new, state.in_basis),
            gamma=select(gamma_new, state.gamma),
            iteration=state.iteration + do_pivot.astype(jnp.int32),
            status=new_status,
            degen_count=select(degen_new, state.degen_count),
            inner=state.inner + 1,
            price_start=select((q + 1) % N, state.price_start).astype(jnp.int32),
            d=select(d_next, state.d),
        )

    return iteration


@functools.partial(
    jax.jit,
    static_argnames=(
        "pricing", "chunk", "opt_tol", "pivot_tol", "degen_tol", "stop_at_zero",
        "noise_eps", "hi_scan",
    ),
)
def df_run_chunk(
    state: DfSimplexState,
    A_scan,
    Ah,
    Al,
    ch,
    cl,
    candidate_mask,
    *,
    pricing: int,
    chunk: int,
    opt_tol: float,
    pivot_tol: float,
    degen_tol: float,
    stop_at_zero: bool = False,
    noise_eps: float = 0.0,
    hi_scan: bool = False,
) -> DfSimplexState:
    """Run up to ``chunk`` df32 pivots on device without host round-trips."""
    iteration = make_df_iteration(
        pricing, opt_tol, pivot_tol, degen_tol,
        noise_eps=noise_eps, hi_scan=hi_scan,
    )
    c_scan = ch
    state = state._replace(
        inner=jnp.zeros((), jnp.int32),
        d=c_scan - state.pi @ A_scan,
    )

    def cond(s):
        running = (s.status == RUNNING) & (s.inner < chunk)
        if stop_at_zero:
            running = running & (s.obj > 1e-9)
        return running

    def body(s):
        return iteration(s, A_scan, Ah, Al, ch, cl, c_scan, candidate_mask)

    return jax.lax.while_loop(cond, body, state)


def df_refactorize(state: DfSimplexState, A: DfMatrix, b: DfVec, c: DfVec,
                   feas_tol: float):
    """Host f64 refactorization, split back into the df carry.

    A compensated on-device Newton-Schulz step would need O(m^3) df
    accumulation; host LAPACK in f64 is faster and reaches ~2^-52, beyond
    the carry's 2^-48.  Only the gathered (m, m) basis matrix crosses the
    host boundary.
    """
    basis_dev = state.basis
    Bh = jnp.take(A.hi, basis_dev, axis=1)
    Bl = jnp.take(A.lo, basis_dev, axis=1)
    B = np.asarray(Bh, dtype=np.float64) + np.asarray(Bl, dtype=np.float64)
    M = B.shape[0]
    try:
        X = np.linalg.inv(B)
    except np.linalg.LinAlgError:
        return state, float("inf")
    residual = float(np.max(np.abs(B @ X - np.eye(M))))
    basis = np.asarray(basis_dev)
    b64 = np.asarray(b.hi, np.float64) + np.asarray(b.lo, np.float64)
    c64 = np.asarray(c.hi, np.float64) + np.asarray(c.lo, np.float64)
    xB = X @ b64
    xB = np.where(xB > -feas_tol, np.maximum(xB, 0.0), xB)
    cB = c64[basis]
    pi = cB @ X
    obj = float(cB @ xB)

    def split(x):
        hi = x.astype(np.float32)
        lo = (x - hi.astype(np.float64)).astype(np.float32)
        return jnp.asarray(hi), jnp.asarray(lo)

    Xh, Xl = split(X)
    xh, xl = split(xB)
    pih, pil = split(pi)
    oh, ol = split(np.float64(obj))
    return (
        state._replace(
            Binv=Xh, Binv_lo=Xl, xB=xh, xB_lo=xl, pi=pih, pi_lo=pil,
            obj=oh, obj_lo=ol,
        ),
        residual,
    )


def df_make_state(A64, b64, c64, basis) -> DfSimplexState:
    """Initial df32 state for an identity starting basis (bench/tests).

    ``A64/b64/c64`` are host f64 arrays; the carry is split hi/lo.
    """
    from relp_tpu.ops.df32 import df_from_f64

    A64 = np.asarray(A64, np.float64)
    b64 = np.asarray(b64, np.float64)
    c64 = np.asarray(c64, np.float64)
    M, N = A64.shape
    in_basis = np.zeros(N, dtype=bool)
    in_basis[basis] = True
    cB = c64[basis]
    d0 = (c64 - cB @ A64).astype(np.float32)
    xh, xl = df_from_f64(b64)
    pih, pil = df_from_f64(cB)
    oh, ol = df_from_f64(np.float64(cB @ b64))
    return DfSimplexState(
        Binv=jnp.eye(M, dtype=jnp.float32),
        Binv_lo=jnp.zeros((M, M), dtype=jnp.float32),
        basis=jnp.asarray(basis, jnp.int32),
        xB=xh,
        xB_lo=xl,
        pi=pih,
        pi_lo=pil,
        obj=oh,
        obj_lo=ol,
        in_basis=jnp.asarray(in_basis),
        gamma=jnp.ones(N, dtype=jnp.float32),
        iteration=jnp.zeros((), jnp.int32),
        status=jnp.asarray(RUNNING, jnp.int32),
        degen_count=jnp.zeros((), jnp.int32),
        inner=jnp.zeros((), jnp.int32),
        price_start=jnp.zeros((), jnp.int32),
        d=jnp.asarray(d0),
    )


@jax.jit
def df_forced_pivot(state: DfSimplexState, A: DfMatrix, c: DfVec, q, r):
    """Unconditional df pivot (zero-level artificial drive-out;
    reference: phase_one.rs:232-278)."""
    q = jnp.asarray(q, jnp.int32)
    r = jnp.asarray(r, jnp.int32)
    a_qh, a_ql = A.hi[:, q], A.lo[:, q]
    wh, wl = df_matvec(state.Binv, state.Binv_lo, a_qh, a_ql)
    w_rh, w_rl = wh[r], wl[r]
    th, tl = df_div(state.xB[r], state.xB_lo[r], w_rh, w_rl)
    beta_h, beta_l = df_div(state.Binv[r], state.Binv_lo[r], w_rh, w_rl)
    ph, pe = two_prod(wh[:, None], beta_h[None, :])
    pe = pe + (wh[:, None] * beta_l[None, :] + wl[:, None] * beta_h[None, :])
    Bh_new, Bl_new = df_sub(state.Binv, state.Binv_lo, ph, pe)
    Bh_new = Bh_new.at[r].set(beta_h)
    Bl_new = Bl_new.at[r].set(beta_l)
    xh_step, xl_step = df_mul(th, tl, wh, wl)
    xBh, xBl = df_sub(state.xB, state.xB_lo, xh_step, xl_step)
    xBh = xBh.at[r].set(th)
    xBl = xBl.at[r].set(tl)
    leaving = state.basis[r]
    basis_new = state.basis.at[r].set(q)
    in_basis_new = state.in_basis.at[leaving].set(False).at[q].set(True)
    cBh, cBl = c.hi[basis_new], c.lo[basis_new]
    pih, pil = df_vecmat(cBh, cBl, Bh_new, Bl_new)
    oh, ol = df_dot(cBh, cBl, xBh, xBl)
    return state._replace(
        Binv=Bh_new,
        Binv_lo=Bl_new,
        basis=basis_new,
        xB=xBh,
        xB_lo=xBl,
        pi=pih,
        pi_lo=pil,
        obj=oh,
        obj_lo=ol,
        in_basis=in_basis_new,
        iteration=state.iteration + 1,
    )


@jax.jit
def df_tableau_row(state: DfSimplexState, A: DfMatrix, r):
    """Row r of the tableau, compensated: (B^-1)[r] @ A."""
    rh, rl = df_vecmat(state.Binv[r], state.Binv_lo[r], A.hi, A.lo)
    return rh
