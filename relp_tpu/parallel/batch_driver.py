"""Batched scenario solves — many LPs per chip in lockstep.

The DP analog for LP solving (BASELINE config: "1024 perturbed Netlib
instances vmapped per chip").  All providers are lowered to a common padded
shape; phase 1 and phase 2 run as vmapped chunked loops with per-LP freezing;
refactorization is vmapped.

Scope (documented): artificials left basic at zero level after phase 1 are
*not* driven out per-LP — they cannot re-enter, and the exact certifier
treats them as identity columns at cost 0 whose exact value must be zero
(a valid primal/dual certificate for the real LP).  LPs that hit numerical
trouble or keep clearly nonzero artificials fall back to the single-LP
driver, which has the full rank-repair machinery.
"""

from __future__ import annotations

import dataclasses
import os as _os
import time
from typing import List, Optional, Sequence

import numpy as np

from relp_tpu.config import SolverConfig, default_config
from relp_tpu.linalg.device import pad_to_multiple
from relp_tpu.linalg.sparse import SparseVector
from relp_tpu.parallel.batch import batched_run_chunk, make_batch_state
from relp_tpu.providers.base import MatrixProvider
from relp_tpu.simplex.driver import _PRICING_CODES
from relp_tpu.simplex.engine import DenseEngine
from relp_tpu.simplex.kernels import PRICE_STEEPEST
from relp_tpu.simplex.lowering import lower_provider
from relp_tpu.simplex.result import OptimizationResult, SolveStats, SolveStatus
from relp_tpu.simplex.state import OPTIMAL, RUNNING, SINGULAR


# ---------------------------------------------------------------------------
# Module-level jitted steps.
#
# These MUST live at module scope: a ``jax.jit`` applied to a closure defined
# inside ``solve_batch`` is a fresh Python object per call, so every
# ``solve_batch`` invocation would retrace and recompile every chunk
# signature.  All problem arrays are arguments, all configuration is static
# kwargs, so repeated solve_batch calls with the same shapes reuse the
# compiled executables.
# ---------------------------------------------------------------------------

import functools

import jax
import jax.numpy as jnp

from relp_tpu.simplex import kernels as _kernels


@functools.partial(jax.jit, static_argnames=("newton_steps",))
def _v_refactor(A, b, c, basis, *, newton_steps):
    return jax.vmap(
        lambda A, b, c, bas: _kernels.refactorize(
            A, b, c, bas, newton_steps=newton_steps
        ),
        in_axes=(0, 0, 0, 0),
    )(A, b, c, basis)


@jax.jit
def _v_gamma(Binv, A_scan, in_basis):
    return jax.vmap(_kernels.recompute_gamma, in_axes=(0, 0, 0))(
        Binv, A_scan, in_basis
    )


@functools.partial(jax.jit, static_argnames=("steps",))
def _v_newton(Binv, A, b, c, basis, *, steps):
    return jax.vmap(
        lambda Binv, A, b, c, bas: _kernels.newton_refresh(
            Binv, A, b, c, bas, steps=steps
        ),
        in_axes=(0, 0, 0, 0, 0),
    )(Binv, A, b, c, basis)


@functools.partial(
    jax.jit,
    static_argnames=(
        "pricing", "chunk", "opt_tol", "pivot_tol", "degen_tol",
        "noise_eps", "stop_at_zero", "hi_scan",
        "newton_steps", "feas_tol", "refactor_period", "use_steepest",
    ),
)
def _batch_step(
    batch, A_scan, A, b, c, cand, *,
    pricing, chunk, opt_tol, pivot_tol, degen_tol, noise_eps,
    stop_at_zero, hi_scan,
    newton_steps, feas_tol, refactor_period, use_steepest,
):
    """One chunk of pivots + Newton-Schulz refresh + gamma refresh as a
    single fused dispatch, returning (new batch, packed (4, B) report) so
    the host needs exactly one small pull per chunk instead of separate
    round trips for the chunk, refactor, gamma and status pulls."""
    from relp_tpu.parallel.batch import batched_run_chunk

    it_before = batch.iteration
    batch = batched_run_chunk(
        batch, A_scan, A, c, cand, stop_at_zero=stop_at_zero,
        hi_scan=hi_scan, pricing=pricing, chunk=chunk, opt_tol=opt_tol,
        pivot_tol=pivot_tol, degen_tol=degen_tol, noise_eps=noise_eps,
        refactor_period=refactor_period,
        b=b if refactor_period > 0 else None,
        newton_steps=newton_steps, feas_tol=feas_tol,
    )
    rearm = jnp.zeros_like(batch.status, dtype=bool)
    if noise_eps > 0 and not hi_scan:
        # On a noisy backend the in-chunk reduced costs are fast-path
        # (default-precision matmuls) and OPTIMAL may be a scan-noise freeze.
        # Only an OPTIMAL reached with ZERO pivots this chunk — i.e.
        # decided by the clean (HIGHEST-precision) chunk-entry d — is
        # final; anything else re-arms, and the host switches the phase
        # to polish chunks (hi_scan: exact HIGHEST-precision scans) so
        # the sub-noise optimality tail terminates instead of thrashing
        # at one pivot per chunk dispatch.
        rearm = (batch.status == OPTIMAL) & (batch.iteration > it_before)
        batch = batch._replace(
            status=jnp.where(rearm, RUNNING, batch.status)
        )
    report = jnp.stack(
        [
            batch.status.astype(A.dtype),
            batch.obj.astype(A.dtype),
            batch.iteration.astype(A.dtype),
            rearm.astype(A.dtype),
        ]
    )
    # Newton-Schulz refresh of the carried inverses (pure batched
    # matmuls, no sequential factorization).
    Binv, xB, pi, obj, residual = _v_newton(
        batch.Binv, A, b, c, batch.basis, steps=2 if newton_steps <= 1 else 3
    )
    xB = jnp.where(xB > -feas_tol, jnp.maximum(xB, 0.0), xB)
    # Numerical breakdown (NaN/diverged carry, e.g. a near-singular f32
    # basis): freeze the LP as SINGULAR instead of letting NaN state
    # burn lockstep chunks until the cap; it falls back per-LP at
    # extraction like any other non-OPTIMAL member.
    broke = (~jnp.isfinite(residual)) | (residual > 1.0)
    batch = batch._replace(
        Binv=Binv, xB=xB, pi=pi, obj=obj,
        status=jnp.where(
            broke & (batch.status == RUNNING), SINGULAR, batch.status
        ).astype(batch.status.dtype),
    )
    if use_steepest:
        batch = batch._replace(gamma=_v_gamma(Binv, A_scan, batch.in_basis))
    return batch, report


def solve_batch(
    providers: Sequence[MatrixProvider],
    config: Optional[SolverConfig] = None,
    *,
    certify: Optional[bool] = None,
    shared_structure: bool = False,
    mesh=None,
    warm_start_basis: Optional[Sequence[int]] = None,
) -> List[OptimizationResult]:
    """Solve a batch of LPs in lockstep on one device or across a mesh.

    ``certify`` overrides the per-config exact-certification flag (defaults
    to the config's; certification runs per LP on the host and dominates for
    large batches).

    ``shared_structure=True`` declares that all providers share the same
    constraint matrix/costs and differ only in the right-hand side (the
    perturbed-scenario case): the tableau is lowered once instead of per
    scenario.

    ``mesh`` (a ``jax.sharding.Mesh`` with "batch" and "col" axes) shards
    the LP scenarios over the "batch" axis and the tableau columns over the
    "col" axis — dp x tp composed; GSPMD partitions the vmapped chunk loop
    and inserts the cross-device pricing argmax combine.

    ``warm_start_basis`` (one basis — provider column per structural row,
    e.g. ``result.basis`` from solving the unperturbed base problem) engages
    the batched *dual-simplex* warm restart: every scenario starts from that
    basis and dual pivots restore per-LP primal feasibility, skipping both
    phases (``cfg.dual_restart``; meaningful with ``shared_structure=True``
    where only b varies, so the base optimum stays dual feasible for every
    scenario).  Scenarios for which the basis is not dual feasible — or that
    prove primal infeasible via a dual ray — go through the cold path /
    single-LP fallback, so verdicts and certificates are unchanged.
    """
    import jax
    import jax.numpy as jnp

    from relp_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    cfg = config or default_config()
    if certify is None:
        certify = cfg.certify
    dtype = np.float64 if cfg.dtype == "float64" else np.float32
    engine = DenseEngine()

    # --- common-shape lowering ---
    max_rows = max(p.nr_rows() for p in providers)
    probe_M = pad_to_multiple(max(max_rows, 1), cfg.pad_to)
    max_cols = max(p.nr_columns() + probe_M for p in providers)
    if shared_structure:
        base = lower_provider(
            providers[0],
            dtype=dtype,
            pad_to=cfg.pad_to,
            equilibrate=cfg.prescale,
            min_rows=max_rows,
            min_cols=max_cols,
        )
        problems = []
        for p in providers:
            b_k = np.zeros(base.M, dtype=dtype)
            for i, v in enumerate(p.right_hand_side()):
                b_k[i] = float(v)
            if base.row_scale is not None:
                b_k *= base.row_scale
            problems.append(
                dataclasses.replace(base, b=b_k, provider=p)
            )
    else:
        problems = [
            lower_provider(
                p,
                dtype=dtype,
                pad_to=cfg.pad_to,
                equilibrate=cfg.prescale,
                min_rows=max_rows,
                min_cols=max_cols,
            )
            for p in providers
        ]
    M, N = problems[0].M, problems[0].N
    assert all(pr.A.shape == (M, N) for pr in problems)

    A = jnp.asarray(np.stack([pr.A for pr in problems]))
    mixed = cfg.scan_dtype not in ("same", cfg.dtype)
    A_scan = A.astype(jnp.dtype(cfg.scan_dtype)) if mixed else A
    b = jnp.asarray(np.stack([pr.b for pr in problems]))
    c1 = jnp.asarray(np.stack([pr.c_phase1 for pr in problems]))
    c2 = jnp.asarray(np.stack([pr.c_phase2 for pr in problems]))
    cand = jnp.asarray(np.stack([pr.candidate_mask for pr in problems]))

    states = [engine.init_state(pr, cfg) for pr in problems]
    batch = make_batch_state(states)

    if mesh is not None:
        from relp_tpu.parallel.sharded import (
            shard_batch_problem,
            shard_batch_state,
        )

        with mesh:
            A, b, c1, cand, A_scan = shard_batch_problem(
                mesh, A, b, c1, cand, A_scan=A_scan if mixed else None
            )
            if not mixed:
                A_scan = A
            c2 = jax.device_put(c2, c1.sharding)
            batch = shard_batch_state(mesh, batch)

    from relp_tpu.simplex import kernels

    newton = 3 if cfg.dtype == "float64" else 1

    from relp_tpu.backend import backend_facts

    # Resolved OUTSIDE every jitted function: noise_eps is a static jit
    # argument (a trace-time read would freeze into shared jit caches).
    noise_eps = backend_facts().scan_noise_eps

    pricing = _PRICING_CODES[cfg.pricing]
    kwargs = dict(
        pricing=pricing,
        chunk=cfg.chunk_size,
        opt_tol=cfg.opt_tol,
        pivot_tol=cfg.pivot_tol,
        degen_tol=cfg.feas_tol,
        noise_eps=noise_eps,
    )
    # In-chunk refactorization cadence (batched_run_chunk): one dispatch
    # carries chunk_size pivots with a vmapped Newton-Schulz refresh every
    # refactor_period loop steps, instead of one host round trip per
    # refactor period.  0 disables (the default: the per-chunk refresh in
    # _batch_step covers chunk_size <= refactor_period).
    in_chunk_period = cfg.refactor_period if cfg.device_refactor else 0

    def refactor(batch, c):
        Binv, xB, pi, obj, residual = _v_refactor(
            A, b, c, batch.basis, newton_steps=newton
        )
        xB = jnp.where(xB > -cfg.feas_tol, jnp.maximum(xB, 0.0), xB)
        return batch._replace(Binv=Binv, xB=xB, pi=pi, obj=obj), residual

    def step(batch, c, stop_at_zero, hi_scan):
        """One chunk through the module-level jitted :func:`_batch_step`
        (pivots + Newton-Schulz refresh + gamma refresh fused into a single
        dispatch with one packed (4, B) report pull)."""
        return _batch_step(
            batch, A_scan, A, b, c, cand,
            stop_at_zero=stop_at_zero, hi_scan=hi_scan,
            newton_steps=newton,
            feas_tol=cfg.feas_tol, refactor_period=in_chunk_period,
            use_steepest=pricing == PRICE_STEEPEST, **kwargs,
        )

    _timing = _os.environ.get("RELP_TPU_BATCH_TIMING", "")

    def _t(label, t_from):
        if _timing:
            print(f"  [batch-timing] {label}: {time.time() - t_from:.3f}s",
                  flush=True)
        return time.time()

    def run_phase(batch, c, stop_at_zero):
        t = time.time()
        if pricing == PRICE_STEEPEST:
            batch = batch._replace(
                gamma=_v_gamma(batch.Binv, A_scan, batch.in_basis)
            )
        # The batched loop has no per-LP Bland/perturbation machinery; a few
        # degenerate stragglers must not hold the whole batch hostage.  LPs
        # still RUNNING after the cap fall back to the single-LP driver.
        max_chunks = min(
            max(1, cfg.max_iterations // max(1, cfg.chunk_size)) + 2, 60
        )
        hi = False
        for _chunk_i in range(max_chunks):
            batch, report = step(batch, c, stop_at_zero, hi)
            report = np.asarray(report)
            t = _t(
                f"phase(stop_at_zero={stop_at_zero}) chunk {_chunk_i} "
                f"(hi={hi})", t,
            )
            status = report[0].astype(np.int32)
            obj = report[1]
            running = status == RUNNING
            if stop_at_zero:
                running = running & (obj > 1e-9)
            if not running.any() or report[2].max() >= cfg.max_iterations:
                break
            if not hi and report[3].max() > 0:
                # Scan-noise freezes appeared: the rest of this phase runs
                # polish chunks (exact pricing) for everyone still running.
                hi = True
        # The returned state is always freshly refactorized (basis-exact
        # xB/pi/obj), which downstream feasibility tests and extraction use.
        return batch

    def try_warm_dual(batch):
        """Start every scenario from ``warm_start_basis`` and restore per-LP
        primal feasibility with batched dual pivots.  Returns (batch,
        per-LP dual pivot counts) on engagement, (batch, None) when the
        basis is not dual feasible for every scenario (cold path instead —
        all-or-nothing keeps the lockstep loops uniform)."""
        from relp_tpu.parallel.batch import batched_dual_run_chunk

        m_real = problems[0].m_real
        if any(pr.m_real != m_real for pr in problems):
            return batch, None  # heterogeneous rows: one shared basis is undefined
        if len(warm_start_basis) != m_real:
            raise ValueError(
                f"warm_start_basis has {len(warm_start_basis)} entries for "
                f"{m_real} structural rows"
            )
        warm_full = problems[0].initial_basis.copy()
        warm_full[:m_real] = np.asarray(warm_start_basis, dtype=np.int32)
        in_b = np.zeros(N, dtype=bool)
        in_b[warm_full] = True
        Bsz = len(problems)
        wb = batch._replace(
            basis=jnp.tile(jnp.asarray(warm_full, jnp.int32), (Bsz, 1)),
            in_basis=jnp.tile(jnp.asarray(in_b), (Bsz, 1)),
        )
        wb, residual = refactor(wb, c2)
        residual = np.asarray(residual)
        # Dual feasibility of the shared basis per scenario, checked on the
        # host in f64 (driver.warm_dual_feasible): reduced costs recomputed
        # from the refactored f32 state carry ~eps_f32*|pi| noise, which
        # silently disengaged every netlib-scale warm restart.  c is per-LP
        # in the general lowering, so check all B reduced-cost vectors
        # (reusing the shared-A factorization when providers share A).
        from relp_tpu.simplex.driver import warm_dual_feasible

        nonbasic = np.asarray(cand) & ~np.asarray(wb.in_basis)
        c2_np = np.asarray(c2)
        dual_ok = True
        dmin_all = 0.0
        for k in range(Bsz):
            if k > 0 and problems[k].A is problems[0].A and np.array_equal(
                c2_np[k], c2_np[0]
            ):
                continue  # identical LP data: same verdict as LP 0
            ok_k, dmin_k, _ = warm_dual_feasible(
                problems[k].A, c2_np[k], warm_full, nonbasic[k], cfg.opt_tol
            )
            dmin_all = min(dmin_all, dmin_k)
            if not ok_k:
                dual_ok = False
                break
        # 1e-4 is the same breakdown threshold every chunk loop uses; a
        # 1e-6 residual gate rejects healthy f32 refactorizations at m>=128.
        if not (
            np.isfinite(residual).all()
            and (residual < 1e-4).all()
            and dual_ok
        ):
            if _os.environ.get("RELP_TPU_BATCH_DEBUG", ""):
                print(
                    "  batch-debug warm disengaged: "
                    f"residual_max={float(np.nanmax(residual)):.3e} "
                    f"dmin_min={dmin_all:.3e} (opt_tol={cfg.opt_tol:g})",
                    flush=True,
                )
            return batch, None
        max_chunks = min(
            max(1, cfg.max_iterations // max(1, cfg.chunk_size)) + 2, 60
        )
        for _ in range(max_chunks):
            wb = batched_dual_run_chunk(
                wb, A_scan, A, c2, cand,
                chunk=cfg.chunk_size,
                opt_tol=cfg.opt_tol,
                pivot_tol=cfg.pivot_tol,
                feas_tol=cfg.feas_tol,
                noise_eps=noise_eps,
            )
            if not (np.asarray(wb.status) == RUNNING).any():
                break
            wb, res = refactor(wb, c2)
            res = np.asarray(res)
            bad = ~np.isfinite(res) | (res > 1e-4)
            if bad.any():
                st = np.asarray(wb.status)
                st = np.where(bad & (st == RUNNING), SINGULAR, st)
                wb = wb._replace(status=jnp.asarray(st.astype(np.int32)))
        return wb, np.asarray(wb.iteration).copy()

    t0 = time.time()
    dual_iters = np.zeros(len(problems), dtype=np.int64)
    warm_engaged = False
    if warm_start_basis is not None and mesh is None and cfg.dual_restart:
        batch_or_cold, warm_dual_iters = try_warm_dual(batch)
        if warm_dual_iters is not None:
            batch = batch_or_cold
            dual_iters = warm_dual_iters
            warm_engaged = True

    if warm_engaged:
        # Both phases skipped.  Dual-OPTIMAL LPs re-enter the primal loop,
        # which re-verifies optimality under the configured pricing rule
        # (and polishes at full precision); dual-INFEASIBLE / SINGULAR /
        # budget-exhausted LPs stay frozen and fall back per LP below.
        phase1_iters = np.zeros(len(problems), dtype=np.int64)
        feasible = np.ones(len(problems), dtype=bool)
        status = np.asarray(batch.status)
        status = np.where(status == OPTIMAL, RUNNING, status)
        batch, _ = refactor(batch, c2)
        batch = batch._replace(status=jnp.asarray(status.astype(np.int32)))
    else:
        # Phase 1 for all (LPs with complete slack bases terminate
        # immediately at zero objective).
        batch = run_phase(batch, c1, stop_at_zero=True)
        phase1_iters = np.asarray(batch.iteration).copy()
        _t("phase 1 total", t0)

        # Phase transition: real costs, reset status for feasible LPs.
        feasible = np.asarray(batch.obj) <= cfg.phase1_tol
        batch, _ = refactor(batch, c2)
        status = np.where(feasible, RUNNING, np.asarray(batch.status))
        batch = batch._replace(status=jnp.asarray(status.astype(np.int32)))

    # Phase 2 + full-precision polish.  After an engaged warm restart the
    # phase is a near-optimal re-verification (~0-3 pivots/LP).
    _t2 = time.time()
    batch = run_phase(batch, c2, stop_at_zero=False)
    _t("phase 2 total", _t2)
    if mixed:
        status = np.asarray(batch.status)
        polish = np.where(status == OPTIMAL, RUNNING, status)
        batch = batch._replace(status=jnp.asarray(polish.astype(np.int32)))
        batch, _ = refactor(batch, c2)
        batch = batched_run_chunk(batch, A, A, c2, cand, **kwargs)

    # Final from-scratch refactorization: extraction must never trust a
    # carried inverse (a diverged Binv can exit the chunk loop with a
    # spuriously OPTIMAL status).  The refactorize residual and the
    # basis-exact xB feasibility gate below route such LPs to the single-LP
    # driver fallback instead of returning garbage as FINITE_OPTIMUM.
    _t3 = time.time()
    batch, final_residual = refactor(batch, c2)
    final_residual = np.asarray(final_residual)
    _t("final refactor", _t3)

    wall = time.time() - t0

    # --- extraction ---
    results: List[OptimizationResult] = []
    status = np.asarray(batch.status)
    basis_all = np.asarray(batch.basis)
    xB_all = np.asarray(batch.xB)
    obj_all = np.asarray(batch.obj)
    c2_np = np.asarray(c2)
    iters = np.asarray(batch.iteration)
    n_fallback = 0
    n_rescued = 0
    _A64_cache = {}
    _debug_gates = _os.environ.get("RELP_TPU_BATCH_DEBUG", "")

    def _host_f64_rescue(k, problem):
        """Re-derive basis-exact xB/obj in f64 on the host (one LU solve).

        The batched from-scratch refactorization runs in f32 (the fast
        path); on an ill-conditioned basis (SHARE1B-class, cond(B) ~ 1e7)
        its residual is legitimately ~1e-3 even when the basis IS the true
        optimum, which used to trip the 1e-4 numerics gate and discard the
        whole batch solve for a full single-LP re-solve.  One backward-
        stable f64 solve per flagged LP settles it: either the recomputed
        state passes the same primal-feasibility/artificial gates (accept,
        with strictly better xB/obj than the f32 refactorization) or the
        basis is genuinely bad (fall back as before)."""
        key = id(problem.A)
        A64 = _A64_cache.get(key)
        if A64 is None:
            A64 = np.asarray(problem.A, dtype=np.float64)
            _A64_cache[key] = A64
        B64 = A64[:, basis_all[k]]
        b64 = np.asarray(problem.b, dtype=np.float64)
        try:
            xB64 = np.linalg.solve(B64, b64)
        except np.linalg.LinAlgError:
            return None
        if not np.all(np.isfinite(xB64)):
            return None
        obj64 = float(np.asarray(c2_np[k], np.float64)[basis_all[k]] @ xB64)
        return xB64, obj64

    for k, (provider, problem) in enumerate(zip(providers, problems)):
        stats = SolveStats(
            iterations=int(iters[k]),
            phase1_iterations=int(phase1_iters[k]),
            dual_iterations=int(dual_iters[k]),
            wall_time_s=wall,
        )
        ok = feasible[k] and status[k] == OPTIMAL
        xB_row = xB_all[k]
        obj_k = float(obj_all[k])

        def _gates(xB_row, residual_ok):
            # Numerics gate on the basis-exact state: finite, small
            # refactorization residual and primal-feasible recomputed xB.
            numerics = ok and (
                residual_ok
                and float(xB_row[: problem.m_real].min()) >= -cfg.feas_tol
            )
            # Zero-level artificials may stay basic: certification handles
            # them (identity column, cost 0, exact value must be 0).  Only a
            # clearly nonzero artificial means the batch solve went wrong.
            artificial = ok and all(
                int(basis_all[k, i]) < problem.art_offset
                or abs(xB_row[i]) <= 1e-6
                for i in range(problem.m_real)
            )
            return numerics, artificial

        numerics_ok, artificial_ok = _gates(
            xB_row,
            bool(np.isfinite(final_residual[k]) and final_residual[k] <= 1e-4),
        )
        rescued = False
        if ok and not (numerics_ok and artificial_ok):
            rescue = _host_f64_rescue(k, problem)
            if rescue is not None:
                xB64, obj64 = rescue
                n_ok, a_ok = _gates(xB64, np.isfinite(obj64))
                if n_ok and a_ok:
                    xB_row, obj_k = xB64, obj64
                    numerics_ok = artificial_ok = True
                    rescued = True
                    n_rescued += 1
        if _debug_gates:
            print(
                f"  batch-debug LP{k}: status={int(status[k])} "
                f"feasible={bool(feasible[k])} iters={int(iters[k])} "
                f"residual={float(final_residual[k]):.3e} "
                f"xBmin={float(xB_row[: problem.m_real].min()):.3e} "
                f"artificial_ok={artificial_ok} rescued={rescued}",
                flush=True,
            )
        if not ok or not numerics_ok or not artificial_ok:
            results.append(_single_lp_fallback(provider, cfg, certify))
            n_fallback += 1
            continue

        structural_basis = [int(basis_all[k, i]) for i in range(problem.m_real)]
        entries = []
        for i in range(problem.m_real):
            j = structural_basis[i]
            if j < problem.n_real and abs(xB_row[i]) > cfg.zero_tol:
                value = xB_row[i]
                if problem.col_scale is not None:
                    value *= problem.col_scale[j]
                entries.append((j, value))
        result = OptimizationResult(
            status=SolveStatus.FINITE_OPTIMUM,
            objective=obj_k,
            basis=structural_basis,
            stats=stats,
        )
        result.float_entries = entries  # type: ignore[attr-defined]
        if certify:
            from relp_tpu.exact.certify import certify_and_repair

            _tc = time.time()
            certify_and_repair(
                result,
                provider,
                structural_basis,
                cfg,
                art_offset=problem.art_offset,
            )
            stats.certify_time_s += time.time() - _tc
            if not result.stats.certified:
                # Documented contract: numerically-troubled LPs fall back to
                # the single-LP driver (which has the full f64 escalation
                # ladder), rather than shipping an uncertified result.
                results.append(_single_lp_fallback(provider, cfg, certify))
                n_fallback += 1
                continue
        else:
            from fractions import Fraction

            result.bfs = SparseVector(
                [(j, Fraction(float(v))) for j, v in entries], problem.n_real
            )
        results.append(result)
    if n_fallback:
        import logging

        logging.getLogger("relp_tpu.batch").info(
            "batch solve: %d/%d LPs fell back to the single-LP driver",
            n_fallback,
            len(providers),
        )
    return results


def _single_lp_fallback(
    provider: MatrixProvider, cfg: SolverConfig, certify: bool
) -> OptimizationResult:
    """Solve one LP through the full single-LP driver (rank repair, Bland,
    f64 escalation); used for batch members that failed the lockstep path."""
    from relp_tpu.simplex.driver import solve_relaxation

    # device_refactor is a batched-chunk concept; dropping it re-clamps
    # chunk_size <= refactor_period in __post_init__ so the single-LP
    # engine never runs a whole oversized chunk of rank-1 updates between
    # host refactorizations.
    single_cfg = dataclasses.replace(
        cfg, certify=certify, device_refactor=False
    )
    result = solve_relaxation(provider, single_cfg)
    result.stats.batch_fallback = True
    return result
