"""Vmapped scenario batches — many LPs per device / across the "batch" axis.

The DP analog for LP solving (SURVEY.md section 2 checklist): every state
member gains a leading batch dimension; all LPs advance in lockstep inside
one ``lax.while_loop`` with an active mask (finished LPs keep their terminal
state); the batch dimension shards across the mesh's "batch" axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from relp_tpu.simplex.kernels import _HI, PRICE_STEEPEST, make_iteration
from relp_tpu.simplex.state import RUNNING, SimplexState


def make_batch_state(states):
    """Stack per-LP states into one batched state."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


@functools.partial(
    jax.jit,
    static_argnames=("chunk", "opt_tol", "pivot_tol", "feas_tol", "noise_eps"),
)
def batched_dual_run_chunk(
    batch_state: SimplexState,
    A_scan,  # (B, M, N)
    A_full,  # (B, M, N)
    c,  # (B, N)
    candidate_mask,  # (B, N)
    *,
    chunk: int,
    opt_tol: float,
    pivot_tol: float,
    feas_tol: float,
    noise_eps: float = 0.0,
) -> SimplexState:
    """Advance every LP by up to ``chunk`` *dual* pivots (lockstep, per-LP
    freezing) — the batched warm-restart path for perturbed-rhs scenario
    families sharing one dual-feasible basis (the base problem's optimum).
    Terminal per-LP statuses: OPTIMAL (primal feasibility restored) or
    INFEASIBLE (dual ray; the driver routes those to the single-LP fallback
    for the exact Farkas certificate)."""
    from relp_tpu.simplex.kernels import make_dual_iteration

    iteration = make_dual_iteration(
        opt_tol, pivot_tol, feas_tol, noise_eps=noise_eps
    )
    v_iter = jax.vmap(iteration, in_axes=(0, 0, 0, 0, 0, 0))
    c_scan = c.astype(A_scan.dtype)
    # HIGHEST: at default precision the batched einsum may be inexact on an
    # accelerator — noisy entry reduced costs break dual-feasibility
    # bookkeeping.
    d = c_scan - jnp.einsum(
        "bm,bmn->bn",
        batch_state.pi.astype(A_scan.dtype),
        A_scan,
        precision=_HI,
    )
    batch_state = batch_state._replace(
        inner=jnp.zeros_like(batch_state.inner), d=d
    )

    def cond(s):
        return jnp.any((s.status == RUNNING) & (s.inner < chunk))

    def body(s):
        new = v_iter(s, A_scan, A_full, c, c_scan, candidate_mask)
        active = s.status == RUNNING

        def sel(n, o):
            extra = (1,) * (n.ndim - 1)
            return jnp.where(active.reshape((-1,) + extra), n, o)

        return jax.tree.map(sel, new, s)

    return jax.lax.while_loop(cond, body, batch_state)


@functools.partial(
    jax.jit,
    static_argnames=(
        "pricing", "chunk", "opt_tol", "pivot_tol", "degen_tol", "stop_at_zero",
        "refactor_period", "newton_steps", "feas_tol", "noise_eps", "hi_scan",
    ),
)
def batched_run_chunk(
    batch_state: SimplexState,
    A_scan,  # (B, M, N), possibly lower precision
    A_full,  # (B, M, N)
    c,  # (B, N)
    candidate_mask,  # (B, N)
    *,
    pricing: int,
    chunk: int,
    opt_tol: float,
    pivot_tol: float,
    degen_tol: float,
    stop_at_zero: bool = False,
    refactor_period: int = 0,
    b=None,  # (B, M) right-hand sides, required when refactor_period > 0
    newton_steps: int = 1,
    feas_tol: float = 1e-9,
    noise_eps: float = 0.0,
    hi_scan: bool = False,
) -> SimplexState:
    """Advance every LP in the batch by up to ``chunk`` pivots.

    ``stop_at_zero`` freezes an LP (status -> OPTIMAL) once its objective
    reaches zero — per-LP phase-1 termination.

    ``refactor_period > 0`` enables the *device-side* refactorization
    cadence: every ``refactor_period`` loop steps the basis inverses of all
    LPs are refreshed on device (vmapped Newton-Schulz, the same scheme the
    host-driven refactorization uses) and the steepest-edge weights and
    reduced costs are refreshed — so a whole phase can run as ONE dispatch
    instead of a host round trip per chunk.
    """
    from relp_tpu.simplex import kernels
    from relp_tpu.simplex.state import OPTIMAL

    iteration = make_iteration(
        pricing, opt_tol, pivot_tol, degen_tol,
        noise_eps=noise_eps, hi_scan=hi_scan,
    )
    v_iter = jax.vmap(iteration, in_axes=(0, 0, 0, 0, 0, 0))
    c_scan = c.astype(A_scan.dtype)

    def refresh_d(s):
        # HIGHEST: at default precision the batched einsum may be inexact on
        # an accelerator — a noisy chunk-entry d fabricates candidates and
        # blocks OPTIMAL forever.
        d = c_scan - jnp.einsum(
            "bm,bmn->bn", s.pi.astype(A_scan.dtype), A_scan, precision=_HI
        )
        return s._replace(d=d)

    # Refresh the carried per-LP reduced costs (pi may have changed between
    # chunks via the vmapped refactorization).
    batch_state = refresh_d(
        batch_state._replace(inner=jnp.zeros_like(batch_state.inner))
    )

    def active_mask(s):
        active = s.status == RUNNING
        if stop_at_zero:
            active = active & (s.obj > 1e-9)
        return active

    if refactor_period > 0:
        assert b is not None, "device-side refactorization needs b"
        # Newton-Schulz refresh of the carried inverses: pure batched
        # matmuls, no sequential factorization.
        v_newton = jax.vmap(
            lambda Binv, A, bb, cc, basis: kernels.newton_refresh(
                Binv, A, bb, cc, basis, steps=max(2, newton_steps + 1)
            ),
            in_axes=(0, 0, 0, 0, 0),
        )
        v_gamma = jax.vmap(kernels.recompute_gamma, in_axes=(0, 0, 0))

        def refresh(s):
            Binv, xB, pi, obj, _residual = v_newton(
                s.Binv, A_full, b, c, s.basis
            )
            xB = jnp.where(xB > -feas_tol, jnp.maximum(xB, 0.0), xB)
            s = s._replace(Binv=Binv, xB=xB, pi=pi, obj=obj)
            if pricing == PRICE_STEEPEST:
                s = s._replace(gamma=v_gamma(Binv, A_scan, s.in_basis))
            return refresh_d(s)

    def cond(carry):
        k, s = carry
        return jnp.any(active_mask(s) & (s.inner < chunk))

    def body(carry):
        k, s = carry
        if refactor_period > 0:
            s = jax.lax.cond(
                (k > 0) & (k % refactor_period == 0),
                refresh,
                lambda x: x,
                s,
            )
        new = v_iter(s, A_scan, A_full, c, c_scan, candidate_mask)
        # Freeze LPs that already terminated.
        active = active_mask(s)

        def sel(n, o):
            extra = (1,) * (n.ndim - 1)
            return jnp.where(active.reshape((-1,) + extra), n, o)

        return k + 1, jax.tree.map(sel, new, s)

    _, out = jax.lax.while_loop(
        cond, body, (jnp.zeros((), jnp.int32), batch_state)
    )
    return out
