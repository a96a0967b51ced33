"""Jitted simplex kernels.

The hot loop (reference call stack SURVEY.md 3.3) as fused dense device work:

* pricing: ``d = c - pi A`` is one (M)x(M,N) matvec; Dantzig picks
  ``argmin d``, steepest-edge picks ``argmax d^2/gamma``
  (reference: strategy/pivot_rule.rs:153-297);
* FTRAN ``w = Binv a_q`` is an (M,M) matvec (reference: generate_column);
* the ratio test is a masked min + tie-break (reference:
  select_primal_pivot_row, tableau/mod.rs:287-313, Bland tie-break);
* the basis change is a rank-1 product-form update of the dense inverse
  (the BasisInverseRows semantics, basis_inverse_rows.rs:131-145) plus a
  recomputed ``pi = c_B Binv``;
* the steepest-edge gamma update follows Goldfarb 1977 exactly as the
  reference implements it (pivot_rule.rs:243-296): work vector
  ``v = w Binv_old``, new pivot row ``rho = Binv_new[r]``, and
  ``gamma_j' = max(gamma_j - 2 abar_j (v a_j) + abar_j^2 gamma_q,
  1 + abar_j^2)``.

Refactorization: gather B = A[:, basis], invert in f32, then Newton-Schulz
iterations in the working dtype (quadratic convergence to ~1e-13) —
replacing the reference's sparse LU refactorization (decomposition/mod.rs)
with a scheme made of dense matrix products.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from relp_tpu.simplex.state import (
    INFEASIBLE,
    OPTIMAL,
    RUNNING,
    SINGULAR,
    UNBOUNDED,
    SimplexState,
)

# Pricing rule codes (static argument to the chunk runner).
PRICE_DANTZIG = 0
PRICE_STEEPEST = 1
PRICE_BLAND = 2  # first-profitable entering + lowest-index leaving
PRICE_FIRST = 3  # first profitable (reference: FirstProfitable)
PRICE_FIRST_MEMORY = 4  # round-robin resume (reference: FirstProfitableWithMemory)

# Default-precision f32 matmuls may be inexact on an accelerator (TF32 on
# the GPU; see relp_tpu.backend, scan_noise_eps), so "same-precision" f32
# scans can carry noise: phantom negative reduced costs above opt_tol that
# keep pricing from ever declaring OPTIMAL.  With ``noise_eps > 0`` the
# iteration treats the scan like a low-precision one (noise-scaled
# eligibility floor + working-precision recheck of the picked column) and
# the drivers re-verify OPTIMAL at a clean chunk boundary.

# State-carrying products (FTRAN, refactorization, residual measurement)
# run at HIGHEST precision: true f32.  Wide pricing / Goldfarb scans
# deliberately stay at default precision — noise there only affects pivot
# choice, which the guards above absorb.
_HI = jax.lax.Precision.HIGHEST


def _select_entering(d, gamma, eligible, pricing: int, N: int, start=None):
    """Entering-column choice; returns (q, any_eligible).

    ``start`` (FirstProfitableWithMemory) resumes the scan after the last
    entering column, wrapping around (reference: pivot_rule.rs:113-150).
    """
    neg_inf = jnp.array(-jnp.inf, dtype=d.dtype)
    any_eligible = jnp.any(eligible)
    if pricing == PRICE_DANTZIG:
        score = jnp.where(eligible, -d, neg_inf)
        q = jnp.argmax(score)
    elif pricing == PRICE_STEEPEST:
        score = jnp.where(eligible, d * d / gamma, neg_inf)
        q = jnp.argmax(score)
    elif pricing == PRICE_FIRST_MEMORY and start is not None:
        idx = jnp.arange(N)
        rotated = (idx - start) % N  # distance past the resume point
        q = jnp.argmin(jnp.where(eligible, rotated, N))
    else:  # Bland / first-profitable: smallest eligible index
        idx = jnp.arange(N)
        q = jnp.min(jnp.where(eligible, idx, N))
        q = jnp.minimum(q, N - 1)
    return q, any_eligible


def _select_leaving(xB, w, basis, pricing: int, pivot_tol: float, M: int):
    """Harris two-pass ratio test; returns (r, any_positive).

    Pass 1 computes the tolerance-relaxed step bound
    ``theta = min (xB_i + delta) / w_i``; pass 2 picks, among rows whose true
    ratio fits under theta, the row with the *largest* pivot element —
    trading a feasibility-tolerance-sized bound violation for much better
    numerical stability than the textbook min-ratio rule (which the exact
    reference can afford, tableau/mod.rs:287-313, but floats cannot).
    Bland mode instead breaks exact near-ties by the smallest leaving basis
    index (anti-cycling; reference: Bland tie-break).
    """
    pos = w > pivot_tol
    big = jnp.array(jnp.inf, dtype=w.dtype)
    safe_w = jnp.where(pos, w, 1.0)
    # Tolerance-negative basic values count as zero — otherwise negative
    # ratios would admit objective-worsening micro-steps and cycling.
    xB_eff = jnp.maximum(xB, 0.0)
    ratio = jnp.where(pos, xB_eff / safe_w, big)
    any_positive = jnp.any(pos)
    if pricing == PRICE_BLAND:
        tmin = jnp.min(ratio)
        near = pos & (ratio <= tmin + 1e-12 * (1.0 + jnp.abs(tmin)))
        r = jnp.argmin(jnp.where(near, basis, jnp.iinfo(jnp.int32).max))
    else:
        # Relative feasibility relaxation: an absolute delta is meaningless
        # on badly-scaled instances (basic values of 1e6 would get zero
        # relaxation relative to their own rounding noise; values of 1e-9
        # would get a 100x-too-large one).
        delta = 1e-7 * (1.0 + xB_eff)
        relaxed = jnp.where(pos, (xB_eff + delta) / safe_w, big)
        theta = jnp.min(relaxed)
        ok = pos & (ratio <= theta)
        r = jnp.argmax(jnp.where(ok, w, -big))
    return r, any_positive


def make_iteration(
    pricing: int,
    opt_tol: float,
    pivot_tol: float,
    degen_tol: float,
    noise_eps: float = 0.0,
    hi_scan: bool = False,
):
    """Build one fused simplex iteration.

    ``A_scan`` is the tableau copy used for the full-width pricing and
    steepest-edge scans (may be float32 under an f64 carry: the scans are
    memory-bound, so an f32 copy halves their traffic); ``A_full`` is the
    working-precision copy used for the FTRAN gather.  Mixed-precision
    termination is polished by full-precision chunks in the driver and
    ultimately by the exact certifier.

    ``noise_eps`` is the backend's default-precision f32 matmul error
    (relp_tpu.backend); 0.0 means the scans are exact f32.

    ``hi_scan`` runs the wide pricing/Goldfarb scans at HIGHEST precision
    (true f32) — the polish mode for noisy backends: slower scans but exact
    pricing, so the optimality tail (candidates below the fast path's noise
    floor) terminates instead of thrashing at one pivot per clean chunk
    entry.
    """

    def iteration(state: SimplexState, A_scan, A_full, c, c_scan, candidate_mask) -> SimplexState:
        M, N = A_scan.shape
        scan_dtype = A_scan.dtype
        low_precision_scan = scan_dtype != A_full.dtype
        # "Same-precision" f32 scans are still noisy on backends whose
        # default-precision matmuls are inexact (noise_eps > 0) — treat them
        # like low-precision scans: noise-scaled floor + recheck of the pick.
        # hi_scan mode computes the scans at HIGHEST, so they are exact.
        noisy = (
            noise_eps > 0
            and not hi_scan
            and not low_precision_scan
            and scan_dtype == jnp.float32
        )
        guarded = low_precision_scan or noisy
        scan_precision = _HI if hi_scan else None

        # --- pricing (reduced costs carried in the state; refreshed per
        # chunk and updated by the fused post-pivot scan below) ---
        d = state.d
        if guarded:
            # Noisy reduced costs carry error ~eps * |pi| * |a|; an absolute
            # 1e-9 threshold would fabricate candidates forever on
            # large-scale problems.  Scale the eligibility floor by |pi|.
            noise = (
                noise_eps if noisy else float(jnp.finfo(scan_dtype).eps) * 8.0
            )
            threshold = opt_tol + noise * (1.0 + jnp.max(jnp.abs(state.pi))).astype(
                scan_dtype
            )
            if noisy:
                # The chunk-entry refresh ran at HIGHEST precision (true
                # f32), so the first iteration of a chunk prices exactly:
                # it is the arbiter that makes "OPTIMAL with zero pivots
                # this chunk" a clean verdict, and guarantees any candidate
                # below -opt_tol gets pivoted at least once per chunk (the
                # scaled floor would otherwise hide small-|d| candidates
                # forever).  Only the in-loop d (fast-path scan) is noisy.
                threshold = jnp.where(
                    state.inner == 0, jnp.asarray(opt_tol, scan_dtype), threshold
                )
        else:
            threshold = jnp.asarray(opt_tol, scan_dtype)
        eligible = candidate_mask & (~state.in_basis) & (d < -threshold)
        gamma = state.gamma.astype(scan_dtype)
        q, any_eligible = _select_entering(
            d, gamma, eligible, pricing, N, start=state.price_start
        )
        q = q.astype(jnp.int32)

        # --- FTRAN (working precision; HIGHEST so the vmapped batched form
        # — a (B,M,M)x(B,M) matmul — stays true f32: w feeds the carried
        # inverse/xB, where default-precision noise compounds per pivot) ---
        a_q = A_full[:, q]
        w = jnp.matmul(state.Binv, a_q, precision=_HI)

        # Recheck the selected column's reduced cost at working precision;
        # a scan-noise candidate means the scan found nothing real, so the
        # chunk reports OPTIMAL and the driver's full-precision polish pass
        # decides true optimality.
        d_q_full = c[q] - jnp.matmul(state.pi, a_q, precision=_HI)
        if guarded:
            # Scan noise cannot fabricate candidates; when the scan already
            # runs at working precision the recheck would only disagree by
            # reduction order and could mask other eligible columns.
            any_eligible = any_eligible & (d_q_full < -opt_tol)

        # --- ratio test ---
        r, any_positive = _select_leaving(
            state.xB, w, state.basis, pricing, pivot_tol, M
        )

        new_status = jnp.where(
            ~any_eligible,
            OPTIMAL,
            jnp.where(~any_positive, UNBOUNDED, RUNNING),
        ).astype(jnp.int32)
        do_pivot = new_status == RUNNING

        # --- basis change (product-form update) ---
        w_r = w[r]
        safe_w_r = jnp.where(do_pivot, w_r, 1.0)
        t = jnp.maximum(state.xB[r], 0.0) / safe_w_r
        Binv_r = state.Binv[r] / safe_w_r
        Binv_new = state.Binv - jnp.outer(w, Binv_r)
        Binv_new = Binv_new.at[r].set(Binv_r)
        xB_new = state.xB - t * w
        xB_new = xB_new.at[r].set(t)

        leaving = state.basis[r]
        basis_new = state.basis.at[r].set(q)
        in_basis_new = state.in_basis.at[leaving].set(False).at[q].set(True)

        # Incremental dual update (one rank-1 instead of a fresh pass over
        # Binv): pi' = pi + d_q rho_r with rho_r the new pivot row — how the
        # reference's carry maintains -pi (carry/mod.rs:561-604 change_basis);
        # drift is repaired at the same refactorization points as Binv.
        # The objective is recomputed as cB@xB (a cheap M-dot): the
        # incremental form obj + t d_q is wrong whenever the Harris clamp
        # zeroes a tolerance-negative leaving value (t uses max(xB_r, 0) but
        # row r is overwritten), which phase 1 hits routinely.
        pi_new = state.pi + d_q_full * Binv_r
        obj_new = c[basis_new] @ xB_new

        # --- fused full-width scans: the next iteration's pricing vector
        # plus (for steepest edge) the two Goldfarb vectors, all in ONE pass
        # over A_scan.  Big tableaus are memory-bound, so one stacked (K,M)x(M,N)
        # matmul instead of three row-vector scans is ~3x less traffic. ---
        if pricing == PRICE_STEEPEST:
            gamma_q_val = (1.0 + w @ w).astype(scan_dtype)
            v = (w @ state.Binv).astype(scan_dtype)  # work vector, OLD inverse
            P = jnp.stack(
                [pi_new.astype(scan_dtype), v, Binv_new[r].astype(scan_dtype)]
            )
            S = jnp.matmul(P, A_scan, precision=scan_precision)
            d_next = c_scan - S[0]
            inner = S[1]
            abar = S[2]  # pivot row of the updated tableau
            gamma_new = gamma - 2.0 * abar * inner + (abar * abar) * gamma_q_val
            gamma_new = jnp.maximum(gamma_new, 1.0 + abar * abar)
            gamma_new = gamma_new.at[leaving].set(
                jnp.maximum(
                    gamma_q_val / (safe_w_r * safe_w_r).astype(scan_dtype), 1.0
                )
            )
            gamma_new = gamma_new.at[q].set(1.0)
            gamma_new = gamma_new.astype(state.gamma.dtype)
        else:
            gamma_new = state.gamma
            d_next = c_scan - jnp.matmul(
                pi_new.astype(scan_dtype), A_scan, precision=scan_precision
            )

        degenerate = t <= degen_tol
        degen_new = jnp.where(degenerate, state.degen_count + 1, 0).astype(jnp.int32)

        select = lambda new, old: jnp.where(do_pivot, new, old)
        return SimplexState(
            Binv=select(Binv_new, state.Binv),
            basis=select(basis_new, state.basis),
            xB=select(xB_new, state.xB),
            pi=select(pi_new, state.pi),
            obj=select(obj_new, state.obj),
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
def run_chunk(
    state: SimplexState,
    A_scan,
    A_full,
    c,
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
) -> SimplexState:
    """Run up to ``chunk`` pivots on device without host round-trips.

    ``A_scan`` may be a lower-precision copy of ``A_full`` (mixed-precision
    pricing); pass the same array twice for full-precision behavior.
    ``stop_at_zero`` ends the loop once the objective is (near) zero — the
    phase-1 termination rule: the artificial cost cannot go below zero, so
    zero means feasible (reference: phase_one.rs on zero artificial cost).
    """
    iteration = make_iteration(
        pricing, opt_tol, pivot_tol, degen_tol,
        noise_eps=noise_eps, hi_scan=hi_scan,
    )
    c_scan = c.astype(A_scan.dtype)
    # Refresh the carried reduced costs at chunk entry: pi may have changed
    # outside the loop (refactorization, phase switch, polish scan switch).
    # HIGHEST: under vmap this row-vector product becomes a batched matmul,
    # which would otherwise run at default precision — a noisy chunk-entry
    # d would fabricate candidates and block OPTIMAL forever.
    state = state._replace(
        inner=jnp.zeros((), jnp.int32),
        d=c_scan
        - jnp.matmul(state.pi.astype(A_scan.dtype), A_scan, precision=_HI),
    )

    def cond(s: SimplexState):
        running = (s.status == RUNNING) & (s.inner < chunk)
        if stop_at_zero:
            running = running & (s.obj > 1e-9)
        return running

    def body(s: SimplexState):
        return iteration(s, A_scan, A_full, c, c_scan, candidate_mask)

    return jax.lax.while_loop(cond, body, state)


def make_dual_iteration(
    opt_tol: float, pivot_tol: float, feas_tol: float, noise_eps: float = 0.0
):
    """One fused *dual* simplex iteration (new capability — the reference
    has no dual simplex; its warm-start story is IM::from_basis,
    carry/mod.rs:444-478, which requires primal feasibility).

    Invariant: dual feasibility (d >= -opt_tol).  Each pivot removes a
    negative basic value while keeping reduced costs nonnegative, so an
    optimal basis for a nearby rhs is restored to optimality in a few
    pivots with no phase 1 — the warm-restart path for changing-b scenario
    batches.

    Leaving rule: most negative basic value.  Entering rule: the dual ratio
    test min d_j / (-alpha_j) over alpha_j < -pivot_tol, tie-broken toward
    the largest |alpha| for stability.
    """

    def iteration(state: SimplexState, A_scan, A_full, c, c_scan, candidate_mask):
        M, N = A_scan.shape
        scan_dtype = A_scan.dtype

        # --- leaving row: most negative basic value ---
        r = jnp.argmin(state.xB).astype(jnp.int32)
        xB_r = state.xB[r]
        feasible = xB_r >= -feas_tol

        # --- pivot row of the tableau: alpha = Binv[r] @ A ---
        rho = state.Binv[r]
        alpha = rho.astype(scan_dtype) @ A_scan
        d = state.d
        if noise_eps > 0 and scan_dtype == jnp.float32:
            # Default-precision scan on a noisy backend: alpha carries noise
            # scaled by |rho| |a_j|; keep phantom entries out of the
            # eligibility set, else the pick fails the working-precision
            # pivot gate below and the LP freezes as SINGULAR.
            alpha_floor = pivot_tol + noise_eps * (
                1.0 + jnp.max(jnp.abs(rho))
            ).astype(scan_dtype)
        else:
            alpha_floor = jnp.asarray(pivot_tol, scan_dtype)
        eligible = (
            candidate_mask & (~state.in_basis) & (alpha < -alpha_floor)
        )
        any_eligible = jnp.any(eligible)

        # Dual ratio test; d is >= -opt_tol, clamp tiny negatives to 0 so
        # ratios stay nonnegative.
        big = jnp.array(jnp.inf, dtype=alpha.dtype)
        d_eff = jnp.maximum(d, 0.0)
        ratio = jnp.where(eligible, d_eff / (-alpha), big)
        tmin = jnp.min(ratio)
        near = eligible & (ratio <= tmin + 1e-7 * (1.0 + jnp.abs(tmin)))
        q = jnp.argmax(jnp.where(near, -alpha, -big)).astype(jnp.int32)

        # --- FTRAN at working precision (HIGHEST: the vmapped batched form
        # is a matmul, which would otherwise run at default precision) ---
        a_q = A_full[:, q]
        w = jnp.matmul(state.Binv, a_q, precision=_HI)
        w_r = w[r]
        pivot_ok = w_r < -jnp.asarray(pivot_tol, w.dtype)

        new_status = jnp.where(
            feasible,
            OPTIMAL,
            jnp.where(~any_eligible, INFEASIBLE,
                      jnp.where(~pivot_ok, SINGULAR, RUNNING)),
        ).astype(jnp.int32)
        do_pivot = new_status == RUNNING

        # --- basis change (identical product-form update to the primal) ---
        safe_w_r = jnp.where(do_pivot, w_r, 1.0)
        t = xB_r / safe_w_r  # >= 0: negative over negative
        Binv_r = state.Binv[r] / safe_w_r
        Binv_new = state.Binv - jnp.outer(w, Binv_r)
        Binv_new = Binv_new.at[r].set(Binv_r)
        xB_new = state.xB - t * w
        xB_new = xB_new.at[r].set(t)

        leaving = state.basis[r]
        basis_new = state.basis.at[r].set(q)
        in_basis_new = state.in_basis.at[leaving].set(False).at[q].set(True)

        # Dual price update: theta_dual = d_q / (-alpha_q) >= 0;
        # d' = d + theta_dual * alpha, d'_q = 0, d'_leaving = theta_dual.
        d_q_full = c[q] - jnp.matmul(state.pi, a_q, precision=_HI)
        theta = d_q_full / (-safe_w_r)
        pi_new = state.pi - theta * state.Binv[r]
        d_next = d + theta.astype(scan_dtype) * alpha
        d_next = d_next.at[q].set(0.0)
        d_next = d_next.at[leaving].set(theta.astype(scan_dtype))
        obj_new = c[basis_new] @ xB_new

        select = lambda new, old: jnp.where(do_pivot, new, old)
        return SimplexState(
            Binv=select(Binv_new, state.Binv),
            basis=select(basis_new, state.basis),
            xB=select(xB_new, state.xB),
            pi=select(pi_new, state.pi),
            obj=select(obj_new, state.obj),
            in_basis=select(in_basis_new, state.in_basis),
            gamma=state.gamma,
            iteration=state.iteration + do_pivot.astype(jnp.int32),
            status=new_status,
            degen_count=state.degen_count,
            inner=state.inner + 1,
            price_start=state.price_start,
            d=select(d_next, state.d),
        )

    return iteration


@functools.partial(
    jax.jit,
    static_argnames=("chunk", "opt_tol", "pivot_tol", "feas_tol", "noise_eps"),
)
def dual_run_chunk(
    state: SimplexState,
    A_scan,
    A_full,
    c,
    candidate_mask,
    *,
    chunk: int,
    opt_tol: float,
    pivot_tol: float,
    feas_tol: float,
    noise_eps: float = 0.0,
) -> SimplexState:
    """Run up to ``chunk`` dual pivots on device without host round-trips."""
    iteration = make_dual_iteration(
        opt_tol, pivot_tol, feas_tol, noise_eps=noise_eps
    )
    c_scan = c.astype(A_scan.dtype)
    state = state._replace(
        inner=jnp.zeros((), jnp.int32),
        d=c_scan
        - jnp.matmul(state.pi.astype(A_scan.dtype), A_scan, precision=_HI),
    )

    def cond(s: SimplexState):
        return (s.status == RUNNING) & (s.inner < chunk)

    def body(s: SimplexState):
        return iteration(s, A_scan, A_full, c, c_scan, candidate_mask)

    return jax.lax.while_loop(cond, body, state)


# Refactorization / refresh matmuls run at HIGHEST precision (_HI):
# default-precision f32 matmuls may be inexact on an accelerator, which would
# cap Newton-Schulz at that accuracy and make the drift-repair residual a lie
# (it then trips the >1e-4 breakdown gates on perfectly good bases).  These
# run once per chunk, so the cost of true f32 is amortized over its pivots.


@functools.partial(jax.jit, static_argnames=("newton_steps",))
def refactorize(A, b, c, basis, *, newton_steps: int = 3):
    """Recompute the basis inverse from scratch.

    f32 inverse + Newton-Schulz refinement in the working dtype (replaces the reference's sparse LU refactorization,
    carry/mod.rs:584-591 + decomposition/mod.rs).

    Returns (Binv, xB, pi, obj, residual) — residual is
    ``max |B Binv - I|`` for breakdown detection.
    """
    M = A.shape[0]
    B = jnp.take(A, basis, axis=1)
    X = jnp.linalg.inv(B.astype(jnp.float32)).astype(A.dtype)
    eye = jnp.eye(M, dtype=A.dtype)
    for _ in range(newton_steps):
        X = jnp.matmul(X, 2.0 * eye - jnp.matmul(B, X, precision=_HI), precision=_HI)
    residual = jnp.max(jnp.abs(jnp.matmul(B, X, precision=_HI) - eye))
    # xB/pi are the basis-exact values feasibility gates and extraction
    # trust; under vmap these matvecs become batched matmuls (default
    # precision would make them inexact on an accelerator).
    xB = jnp.matmul(X, b, precision=_HI)
    cB = c[basis]
    pi = jnp.matmul(cB, X, precision=_HI)
    obj = cB @ xB
    return X, xB, pi, obj, residual


@functools.partial(jax.jit, static_argnames=("steps",))
def newton_refresh(Binv, A, b, c, basis, *, steps: int = 2):
    """Refresh the carried inverse by Newton-Schulz iteration instead of a
    fresh factorization: X <- X (2I - B X), squaring the residual each step.

    The product-form inverse after a chunk of rank-1 updates has residual
    ~1e-3..1e-4 (f32), an excellent Newton starting point — two steps reach
    the f32 floor.  Pure (batched) matmuls, unlike ``jnp.linalg.inv``,
    whose pivoted factorization is a chain of sequential small steps.

    Returns (Binv, xB, pi, obj, residual) like ``refactorize``; a diverged
    X (singular drift) keeps a large residual, which callers detect.
    """
    M = A.shape[0]
    B = jnp.take(A, basis, axis=1)
    eye = jnp.eye(M, dtype=A.dtype)
    X = Binv
    for _ in range(steps):
        X = jnp.matmul(X, 2.0 * eye - jnp.matmul(B, X, precision=_HI), precision=_HI)
    residual = jnp.max(jnp.abs(jnp.matmul(B, X, precision=_HI) - eye))
    xB = jnp.matmul(X, b, precision=_HI)
    cB = c[basis]
    pi = jnp.matmul(cB, X, precision=_HI)
    obj = cB @ xB
    return X, xB, pi, obj, residual


@jax.jit
def carry_health(Binv, A, b, c, basis, xB, pi):
    """Accurate carry-health residual via f64 device matvecs.

    The f32 HIGHEST max|B X - I| measurement floors at ~sqrt(m)*eps*row
    norms — 1.2e-4 at m=5120 on netlib 80BAU3B, above every honest gate
    even for a PERFECT inverse, so the refresh gate can never pass and
    every chunk exit pays the host-LAPACK fallback.  Matvecs are only
    O(m^2), where an (M,M,M) f64 matmul would be O(m^3).  Health = max of
    three RELATIVE residuals:

      feas  = max|B xB - b|    / (1 + max|b|)     — (BX-I) probed along b
      dual  = max|pi B - cB|   / (1 + max|cB|)    — row-side probe along cB
      probe = max|B(X V) - V|  / (1 + max|X V|)   — 4 Rademacher probes
                                                    against cancellation

    Requires jax_enable_x64 (callers guard); values ~1e-6..1e-5 for a
    healthy f32 carry, ~1e-3+ for genuine drift/singularity.
    """
    f64 = jnp.float64
    M = Binv.shape[0]
    B = jnp.take(A, basis, axis=1).astype(f64)
    b64 = b.astype(f64)
    xB64 = xB.astype(f64)
    feas = jnp.max(jnp.abs(B @ xB64 - b64)) / (1.0 + jnp.max(jnp.abs(b64)))
    cB64 = jnp.take(c, basis).astype(f64)
    dual = jnp.max(jnp.abs(pi.astype(f64) @ B - cB64)) / (
        1.0 + jnp.max(jnp.abs(cB64))
    )
    # Deterministic Rademacher probes (hash of the index grid).
    k = 4
    ij = (
        jax.lax.broadcasted_iota(jnp.uint32, (M, k), 0)
        * jnp.uint32(2654435761)
        + jax.lax.broadcasted_iota(jnp.uint32, (M, k), 1) * jnp.uint32(40503)
    )
    V = jnp.where((ij >> 13) & 1, 1.0, -1.0).astype(f64)
    XV = Binv.astype(f64) @ V
    probe = jnp.max(jnp.abs(B @ XV - V)) / (1.0 + jnp.max(jnp.abs(XV)))
    return jnp.maximum(feas, jnp.maximum(dual, probe))


@jax.jit
def recompute_gamma(Binv, A_scan, in_basis):
    """Exact steepest-edge weights gamma_j = 1 + ||Binv a_j||^2
    (reference: initial_gamma, pivot_rule.rs:299-305).

    Runs in the scan precision — this is a full (M,M)x(M,N) matmul.
    """
    W = Binv.astype(A_scan.dtype) @ A_scan
    gamma = 1.0 + jnp.sum(W * W, axis=0)
    return jnp.where(in_basis, 1.0, gamma).astype(Binv.dtype)


@jax.jit
def tableau_row(Binv, A, r):
    """Row r of the current tableau: Binv[r] @ A (used to drive artificials
    out of the basis; reference: remove_artificial_basis_variables)."""
    return Binv[r] @ A


@jax.jit
def reduced_costs(pi, A, c):
    return c - pi @ A


@functools.partial(jax.jit, donate_argnames=("state",))
def forced_pivot(state: SimplexState, A, c, q, r):
    """Pivot column q in at row r unconditionally (zero-level pivots while
    driving artificials out; reference: phase_one.rs:232-278)."""
    q = jnp.asarray(q, jnp.int32)
    r = jnp.asarray(r, jnp.int32)
    a_q = A[:, q]
    w = state.Binv @ a_q
    w_r = w[r]
    t = state.xB[r] / w_r
    Binv_r = state.Binv[r] / w_r
    Binv_new = state.Binv - jnp.outer(w, Binv_r)
    Binv_new = Binv_new.at[r].set(Binv_r)
    xB_new = state.xB - t * w
    xB_new = xB_new.at[r].set(t)
    leaving = state.basis[r]
    basis_new = state.basis.at[r].set(q)
    in_basis_new = state.in_basis.at[leaving].set(False).at[q].set(True)
    cB = c[basis_new]
    pi_new = cB @ Binv_new
    obj_new = cB @ xB_new
    return state._replace(
        Binv=Binv_new,
        basis=basis_new,
        xB=xB_new,
        pi=pi_new,
        obj=obj_new,
        in_basis=in_basis_new,
        iteration=state.iteration + 1,
    )
