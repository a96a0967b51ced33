"""Host-side solve orchestration.

The analog of the reference's solve facade + phase drivers
(algorithm/mod.rs:17-47, two_phase/mod.rs:25-109, phase_one.rs, phase_two.rs):

* phase 1 minimizes the artificial cost from a partially-artificial start,
* leftover zero-level artificials are driven out; rows where that is
  impossible are removed as redundant (rank repair; reference:
  RemoveRows + from_artificial_removing_rows),
* phase 2 runs the real costs,
* the device does chunked pivots; the host only refactorizes between chunks,
  switches pricing to Bland's rule under degeneracy stalls, and finally
  certifies the basis exactly (reference analog: exact arithmetic
  throughout + debug_assert_in_basic_feasible_solution_state).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np

from relp_tpu.backend import backend_facts
from relp_tpu.config import SolverConfig, default_config
from relp_tpu.linalg.sparse import SparseVector
from relp_tpu.providers.base import MatrixProvider
from relp_tpu.simplex.kernels import (
    PRICE_BLAND,
    PRICE_DANTZIG,
    PRICE_FIRST,
    PRICE_FIRST_MEMORY,
    PRICE_STEEPEST,
)
from relp_tpu.simplex.lowering import (
    DeviceProblem,
    lower_provider,
    lower_removing_rows,
)
from relp_tpu.simplex.result import OptimizationResult, SolveStats, SolveStatus
from relp_tpu.utils.logging import get_logger

_log = get_logger("driver")
from relp_tpu.simplex.state import (
    OPTIMAL,
    RUNNING,
    SINGULAR,
    UNBOUNDED,
    SimplexState,
)

_PRICING_CODES = {
    "dantzig": PRICE_DANTZIG,
    "steepest": PRICE_STEEPEST,
    "first": PRICE_FIRST,
    "first_memory": PRICE_FIRST_MEMORY,
}


def _np_dtype(cfg: SolverConfig):
    return np.float64 if cfg.dtype == "float64" else np.float32


def _lower_dtype(cfg: SolverConfig):
    # The df32 carry lowers problem data in f64 and splits it into hi/lo
    # pairs on device, so data accuracy matches the compensated carry.
    return np.float64 if cfg.carry == "df32" else _np_dtype(cfg)


def _device_arrays(problem: DeviceProblem, cfg: SolverConfig):
    """Device arrays for the lowered problem: (A, A_scan, b, c1, c2, mask).

    For carry="df32" the f64 lowering is split into DfMatrix/DfVec hi+lo
    pairs; A_scan is the hi part (the f32 pricing-scan copy).
    """
    import jax.numpy as jnp

    if cfg.carry == "df32":
        from relp_tpu.ops.df32 import df_from_f64
        from relp_tpu.simplex.df_kernels import DfMatrix, DfVec

        A = DfMatrix(*df_from_f64(problem.A))
        A_scan = A.hi
        b = DfVec(*df_from_f64(problem.b))
        c1 = DfVec(*df_from_f64(problem.c_phase1))
        c2 = DfVec(*df_from_f64(problem.c_phase2))
    else:
        A = jnp.asarray(problem.A)
        if cfg.scan_dtype != "same" and cfg.scan_dtype != cfg.dtype:
            A_scan = A.astype(jnp.dtype(cfg.scan_dtype))
        else:
            A_scan = A
        b = jnp.asarray(problem.b)
        c1 = jnp.asarray(problem.c_phase1)
        c2 = jnp.asarray(problem.c_phase2)
    return A, A_scan, b, c1, c2, jnp.asarray(problem.candidate_mask)


def _run_phase(
    engine,
    state,
    problem: DeviceProblem,
    A_scan,
    A_full,
    b,
    c,
    candidate_mask,
    cfg: SolverConfig,
    stats: SolveStats,
    stop_at_zero: bool = False,
):
    """Run chunks until the phase terminates.

    With mixed-precision scans, an OPTIMAL verdict from the low-precision
    pricing is *polished*: the loop continues with full-precision scans until
    optimal at working precision.
    """
    import jax.numpy as jnp

    pricing = _PRICING_CODES[cfg.pricing]
    mixed = A_scan is not A_full
    # Default-precision f32 scans are inexact on some backends
    # (relp_tpu.backend, scan_noise_eps): an in-chunk OPTIMAL may be a
    # scan-noise freeze, so it is only final when reached with zero pivots
    # in its chunk — i.e. decided by the clean (HIGHEST-precision)
    # chunk-entry reduced costs.
    noisy = (
        not mixed
        and backend_facts().scan_noise_eps > 0
        and getattr(A_scan, "dtype", None) == jnp.float32
    )
    if pricing == PRICE_STEEPEST:
        state = engine.recompute_gamma(state, A_scan)

    bland_mode = False
    polishing = False
    max_chunks = max(1, cfg.max_iterations // max(1, cfg.chunk_size)) + 2
    last_obj: Optional[float] = None
    stall_chunks = 0
    # EXPAND-style anti-degeneracy: when even Bland stalls, shift the basic
    # values by a tiny deterministic positive jitter so ratio tests become
    # nondegenerate; the shift is removed (refactor against the true b) once
    # the perturbed walk terminates, then polishing resumes.
    perturbed = False
    perturb_episodes = 0
    chunk_exits = 0

    def _jitter(state):
        import jax.numpy as jnp

        M = state.xB.shape[0]
        idx = np.arange(M)
        eps = 1e-7 * (1.0 + ((idx * 37) % 19) / 19.0)
        return state._replace(xB=state.xB + jnp.asarray(eps, state.xB.dtype))

    nan_retries = 0
    for _ in range(max_chunks):
        mode = PRICE_BLAND if bland_mode else pricing
        scan = A_full if polishing else A_scan
        it_before = int(state.iteration)
        state_entry = state
        state = engine.run_chunk(
            state, scan, A_full, c, candidate_mask, mode, cfg,
            stop_at_zero=stop_at_zero,
            # Noisy-backend polish: same array, HIGHEST-precision scans.
            hi_scan=polishing and noisy,
        )
        stats.chunks += 1
        if not np.isfinite(float(state.obj)):
            # One catastrophic pivot (w_r barely above pivot_tol with huge
            # basic values) can blow the product-form carry to inf/nan
            # mid-chunk (netlib 80BAU3B at m=5120/f32).  The chunk-entry
            # state is still good: roll back, clean the carry, and retry
            # the chunk once with a conservative pivot tolerance so the
            # ratio test skips near-singular leaving rows, instead of
            # aborting the whole rung to the escalation ladder.
            nan_retries += 1
            _log.info(
                "chunk exploded to nan (retry %d): rolling back %d pivots, "
                "retrying with pivot_tol=1e-5",
                nan_retries, int(state.iteration) - it_before,
            )
            if nan_retries > 3:
                state = state_entry._replace(
                    status=jnp.asarray(SINGULAR, jnp.int32)
                )
                break
            state, residual = engine.refactor(
                state_entry, A_full, b, c, cfg, stats
            )
            if not np.isfinite(residual) or residual > 1e-4:
                state = state._replace(status=jnp.asarray(SINGULAR, jnp.int32))
                break
            safe_cfg = dataclasses.replace(
                cfg, pivot_tol=max(cfg.pivot_tol, 1e-5)
            )
            state = engine.run_chunk(
                state, scan, A_full, c, candidate_mask, mode, safe_cfg,
                stop_at_zero=stop_at_zero,
                hi_scan=polishing and noisy,
            )
            stats.chunks += 1
            if not np.isfinite(float(state.obj)):
                state = state._replace(status=jnp.asarray(SINGULAR, jnp.int32))
                break
        status = int(state.status)
        if stop_at_zero and float(state.obj) <= 1e-9:
            # Phase 1 reached zero artificial cost: feasible.
            break

        # Degenerate-vertex stall detection: tolerance-sized Harris steps can
        # keep pivoting without objective progress; a stalled objective over
        # whole chunks switches to Bland's rule until progress resumes.
        obj = float(state.obj)
        progressed = last_obj is None or (last_obj - obj) > 1e-12 * (1.0 + abs(obj))
        last_obj = obj
        if progressed:
            stall_chunks = 0
            if bland_mode and status == RUNNING:
                bland_mode = False
        elif status == RUNNING:
            stall_chunks += 1
            if stall_chunks >= 2:
                bland_mode = True
            if stall_chunks >= 4 and not perturbed and perturb_episodes < 3:
                # Even Bland is stuck on a massively degenerate vertex:
                # perturb the basic values and walk the nondegenerate problem.
                perturbed = True
                perturb_episodes += 1
                bland_mode = False
                stall_chunks = 0
                state = _jitter(state)
                continue
        if status != RUNNING and perturbed:
            # The perturbed walk terminated; remove the shift and polish on
            # the true right-hand side.
            perturbed = False
            state, residual = engine.refactor(state, A_full, b, c, cfg, stats)
            if not np.isfinite(residual) or residual > 1e-4:
                state = state._replace(status=jnp.asarray(SINGULAR, jnp.int32))
                break
            if pricing == PRICE_STEEPEST:
                state = engine.recompute_gamma(state, scan)
            state = state._replace(status=jnp.asarray(RUNNING, jnp.int32))
            last_obj = None
            continue
        if status == OPTIMAL and mixed and not polishing:
            # Low-precision scans said optimal; continue at full precision.
            polishing = True
            state, residual = engine.refactor(state, A_full, b, c, cfg, stats)
            if not np.isfinite(residual) or residual > 1e-4:
                state = state._replace(status=jnp.asarray(SINGULAR, jnp.int32))
                break
            if pricing == PRICE_STEEPEST:
                state = engine.recompute_gamma(state, A_full)
            state = state._replace(status=jnp.asarray(RUNNING, jnp.int32))
            continue
        if (
            status == OPTIMAL
            and noisy
            and not polishing
            and int(state.iteration) > it_before
        ):
            # Scan-noise freeze mid-chunk (the fast-path in-loop reduced
            # costs are default-precision matmuls): switch to polish
            # chunks — same scan array at HIGHEST precision, i.e. exact
            # pricing — for the optimality tail.  An OPTIMAL reached with
            # zero pivots was decided by the clean chunk-entry d and is
            # accepted below without polish.
            polishing = True
            state, residual = engine.refactor(state, A_full, b, c, cfg, stats)
            if not np.isfinite(residual) or residual > 1e-4:
                state = state._replace(status=jnp.asarray(SINGULAR, jnp.int32))
                break
            if pricing == PRICE_STEEPEST:
                state = engine.recompute_gamma(state, scan)
            state = state._replace(status=jnp.asarray(RUNNING, jnp.int32))
            last_obj = None
            continue
        if status != RUNNING:
            # In Bland mode, verify optimality under the configured rule too
            # (Bland uses the same eligibility set, so OPTIMAL is OPTIMAL).
            if bland_mode and status == OPTIMAL:
                bland_mode = False
            break

        if getattr(state, "degen_count", None) is not None and int(
            getattr(state, "degen_count")
        ) >= cfg.bland_threshold:
            bland_mode = True

        state, residual = engine.refactor(state, A_full, b, c, cfg, stats)
        if not np.isfinite(residual) or residual > 1e-4:
            # The chunk walked into a (near-)singular basis: a dependent
            # column can enter when the floored f32 carry misjudges its
            # w_r as > pivot_tol (80BAU3B at m=5120).  The chunk-entry
            # basis was still factorizable — roll back and retry the chunk
            # with a conservative pivot tolerance so near-zero leaving
            # pivots are skipped, before giving up the rung.
            nan_retries += 1
            _log.info(
                "refactor breakdown after chunk (res %s, retry %d): "
                "rolling back %d pivots, retrying with pivot_tol=1e-5",
                residual, nan_retries, int(state.iteration) - it_before,
            )
            recovered = False
            if nan_retries <= 3:
                state_rb, res_rb = engine.refactor(
                    state_entry, A_full, b, c, cfg, stats
                )
                if np.isfinite(res_rb) and res_rb <= 1e-4:
                    safe_cfg = dataclasses.replace(
                        cfg, pivot_tol=max(cfg.pivot_tol, 1e-5)
                    )
                    state_rb = engine.run_chunk(
                        state_rb, scan, A_full, c, candidate_mask, mode,
                        safe_cfg, stop_at_zero=stop_at_zero,
                        hi_scan=polishing and noisy,
                    )
                    stats.chunks += 1
                    state_rb, res_rb = engine.refactor(
                        state_rb, A_full, b, c, cfg, stats
                    )
                    if np.isfinite(res_rb) and res_rb <= 1e-4:
                        state = state_rb
                        recovered = True
            if not recovered:
                state = state._replace(status=jnp.asarray(SINGULAR, jnp.int32))
                break
        if cfg.debug_validate and getattr(state, "Binv", None) is not None:
            from relp_tpu.utils.debug import validate_bfs_state

            if cfg.carry == "df32":
                validate_bfs_state(
                    state, A_full.hi, b.hi, c.hi, feas_tol=max(cfg.feas_tol, 1e-5) * 1e4
                )
            else:
                validate_bfs_state(state, A_full, b, c, feas_tol=cfg.feas_tol * 1e4)
        if perturbed:
            state = _jitter(state)  # refactor recomputed xB from the true b
        chunk_exits += 1
        if pricing == PRICE_STEEPEST and (
            chunk_exits % max(1, cfg.gamma_refresh_period) == 0
        ):
            # Refresh drifted gamma weights at refactorization points.
            state = engine.recompute_gamma(state, scan)
        if int(state.iteration) >= cfg.max_iterations:
            break

    return state


def _run_dual_phase(
    engine,
    state,
    A_scan,
    A_full,
    b,
    c,
    candidate_mask,
    cfg: SolverConfig,
    stats: SolveStats,
):
    """Dual-simplex pivots until primal feasibility is restored.

    Precondition: the current basis is dual feasible (checked by the caller).
    Terminal states: OPTIMAL (primal feasible again — since dual feasibility
    is the invariant, the basis is optimal), INFEASIBLE (dual unbounded =
    primal infeasible), SINGULAR, or RUNNING (budget exhausted).  The caller
    treats anything but OPTIMAL as "fall back to a cold start" so that the
    exact certification paths (Farkas et al.) stay the single source of
    truth for negative verdicts.
    """
    import jax.numpy as jnp

    max_chunks = max(1, cfg.max_iterations // max(1, cfg.chunk_size)) + 2
    for _ in range(max_chunks):
        state = engine.dual_run_chunk(
            state, A_scan, A_full, c, candidate_mask, cfg
        )
        stats.chunks += 1
        status = int(state.status)
        if status != RUNNING:
            break
        state, residual = engine.refactor(state, A_full, b, c, cfg, stats)
        if not np.isfinite(residual) or residual > 1e-4:
            state = state._replace(status=jnp.asarray(SINGULAR, jnp.int32))
            break
        if int(state.iteration) >= cfg.max_iterations:
            break
    return state


def _drive_out_artificials(
    engine,
    state,
    problem: DeviceProblem,
    A,
    b,
    c,
    cfg: SolverConfig,
    stats: SolveStats,
):
    """Pivot zero-level artificials out of the basis; return redundant rows
    (reference: remove_artificial_basis_variables, phase_one.rs:232-278)."""
    basis = np.asarray(state.basis)
    artificial_rows = [
        i for i in range(problem.m_real) if basis[i] >= problem.art_offset
    ]
    redundant: List[int] = []
    for r in artificial_rows:
        row = engine.tableau_row(state, A, r)
        in_basis = np.asarray(state.in_basis)
        candidates = np.where(
            (~in_basis[: problem.n_real])
            & (np.abs(row[: problem.n_real]) > 1e-7)
        )[0]
        if candidates.size:
            q = int(candidates[np.argmax(np.abs(row[candidates]))])
            # The LU engine's eta ring has fixed capacity; refactorize
            # before it would overflow (JAX would clamp the write index and
            # silently corrupt the inverse).
            eta_count = getattr(state, "eta_count", None)
            if eta_count is not None and int(eta_count) >= cfg.refactor_period - 1:
                state, _res = engine.refactor(state, A, b, c, cfg, stats)
            state = engine.forced_pivot(state, A, c, q, r)
        else:
            redundant.append(r)
    return state, redundant


def solve_relaxation(
    provider: MatrixProvider,
    config: Optional[SolverConfig] = None,
    *,
    warm_start_basis: Optional[List[int]] = None,
    mesh=None,
) -> OptimizationResult:
    """Two-phase revised simplex over a provider
    (reference: SolveRelaxation::solve_relaxation, two_phase/mod.rs:25-109).

    ``warm_start_basis`` is a provider-column index per structural row; a
    feasible basis skips phase 1 entirely (reference: IM::from_basis_pivots +
    the FullInitialBasis specialization; also the checkpoint/resume recipe —
    persist ``result.basis``, resume by passing it here).  An infeasible warm
    basis falls back to a cold start.

    On numerical breakdown (singular refactorization), retries once with
    conservative settings: full-precision scans, larger pivot tolerance,
    frequent refactorization.
    """
    import dataclasses

    cfg0 = config or default_config()

    # Very large + very sparse on the CPU backend: the dense lowering would
    # be hundreds of MB with O(m^3) dense refactorizations; route to the
    # sparse host backend (f64 + exact certification — no escalation ladder
    # needed on top).
    if cfg0.backend == "host_sparse" or (
        cfg0.backend == "auto" and mesh is None and _use_host_sparse(provider, cfg0)
    ):
        from relp_tpu.simplex.host_sparse import solve_relaxation_host_sparse

        result = solve_relaxation_host_sparse(
            provider, cfg0, warm_start_basis=warm_start_basis
        )
        if not hasattr(result, "provider"):
            result.provider = provider  # type: ignore[attr-defined]
        return result

    result = _solve_relaxation_once(provider, cfg0, warm_start_basis, mesh)
    # __post_init__ clamps tolerances in place for f32; dtype escalation must
    # restore the user-requested (pre-clamp) values or the "conservative"
    # f64 retries would run with f32-grade tolerances.
    tol_reset = getattr(cfg0, "requested_tolerances", {})
    if result.status is SolveStatus.NUMERICAL_ERROR:
        # Escalation ladder: where f64 is not native, the double-float
        # (two-f32) carry first — it fixes drift- and accumulation-induced
        # singular bases (e.g. netlib CYCLE/GROW7) at f32 speed — then f64
        # with a tighter refactorization cadence, then the fully
        # conservative configuration.
        ladder = []
        if (
            cfg0.dtype == "float32"
            and cfg0.carry == "native"
            and mesh is None
            and not backend_facts().f64_native
        ):
            ladder.append(
                dataclasses.replace(
                    cfg0,
                    carry="df32",
                    refactor_period=min(cfg0.refactor_period, 100),
                    chunk_size=min(cfg0.chunk_size, 100),
                    **tol_reset,
                )
            )
        ladder.append(
            dataclasses.replace(
                cfg0,
                dtype="float64",
                carry="native",
                refactor_period=min(cfg0.refactor_period, 60),
                chunk_size=min(cfg0.chunk_size, 60),
                **tol_reset,
            )
        )
        ladder.append(
            dataclasses.replace(
                cfg0,
                dtype="float64",
                carry="native",
                refactor_period=30,
                chunk_size=30,
                scan_dtype="same",
                **{
                    **tol_reset,
                    "pivot_tol": max(
                        tol_reset.get("pivot_tol", cfg0.pivot_tol), 1e-7
                    ),
                },
            )
        )
        applied: List[str] = []
        for retry_cfg in ladder:
            applied.append(
                "df32" if retry_cfg.carry == "df32" else retry_cfg.dtype
            )
            _log.info(
                "escalation (numerical error): entering rung %s", applied[-1]
            )
            result = _solve_relaxation_once(
                provider, retry_cfg, warm_start_basis, mesh
            )
            result.stats.escalations = list(applied)
            _log.info(
                "rung %s: status=%s certified=%s iters=%d",
                applied[-1], result.status.value, result.stats.certified,
                result.stats.iterations,
            )
            # Keep climbing while the verdict is uncertified: a rung can
            # return a *wrong but non-numerical* verdict (e.g. a df32
            # phase 1 stalling above phase1_tol reports INFEASIBLE on a
            # feasible LP — netlib 25FV47; the exact Farkas check
            # correctly refuses to certify it), and stopping there ships
            # that verdict even though the next rung solves the LP.
            if result.status is not SolveStatus.NUMERICAL_ERROR and (
                not cfg0.certify or result.stats.certified
            ):
                break
    elif (
        cfg0.dtype == "float32"
        and cfg0.certify
        and (
            result.status
            in (
                SolveStatus.ITERATION_LIMIT,
                SolveStatus.FINITE_OPTIMUM,
                SolveStatus.INFEASIBLE,
                SolveStatus.UNBOUNDED,
            )
        )
        and not result.stats.certified
    ):
        # f32 escalation: the fast path found something uncertifiable —
        # re-solve at f64 (preceded by the double-float carry where f64 is
        # not native), warm-started from the best basis so far.
        ladder = []
        if (
            cfg0.carry == "native"
            and mesh is None
            and not backend_facts().f64_native
        ):
            ladder.append(
                dataclasses.replace(cfg0, carry="df32", **tol_reset)
            )
        ladder.append(
            dataclasses.replace(
                cfg0, dtype="float64", carry="native", **tol_reset
            )
        )
        _log.info(
            "escalation (uncertified %s at f32): climbing the ladder",
            result.status.value,
        )
        applied = []
        for retry_cfg in ladder:
            applied.append(
                "df32" if retry_cfg.carry == "df32" else retry_cfg.dtype
            )
            # The previous attempt's basis is only a usable warm start when
            # it still matches the full provider: rank repair shrinks it
            # (removed rows), and INFEASIBLE/phase-1 bases may contain
            # artificial indices (>= art_offset) that mean nothing to a
            # fresh lowering.  A stale-shaped warm basis crashed the ladder
            # on rank-deficient instances (netlib SCORPION under bucketed
            # lowering).
            warm = warm_start_basis
            if (
                result.basis
                and not result.stats.removed_rows
                and (
                    result.art_offset is None
                    or all(j < result.art_offset for j in result.basis)
                )
            ):
                warm = result.basis
            result = _solve_relaxation_once(provider, retry_cfg, warm, mesh)
            result.stats.escalations = list(applied)
            _log.info(
                "rung %s: status=%s certified=%s iters=%d",
                applied[-1], result.status.value, result.stats.certified,
                result.stats.iterations,
            )
            if result.stats.certified:
                break
    # The provider the verdict refers to, for certificate export
    # (relp_tpu.exact.certificate) and other post-hoc exact consumers.
    # setdefault semantics: the inner solve attaches the rank-repaired /
    # filtered provider its basis actually indexes — never clobber it.
    if not hasattr(result, "provider"):
        result.provider = provider  # type: ignore[attr-defined]
    return result


def warm_dual_feasible(A, c, basis_full, nonbasic_mask, opt_tol):
    """Host f64 dual-feasibility check for warm-start engagement.

    The device state is f32: reduced costs recomputed from a refactored f32
    ``pi`` carry ~``eps_f32 * |pi| * |a|`` noise (measured -4.9e-4 on
    ADLITTLE for an exactly-optimal basis), which silently disengaged every
    netlib-scale warm restart at ``opt_tol``.  Solve ``Bᵀπ = c_B`` in f64 on
    the host instead, and tolerate *data-quantization*-scale negatives: a
    basis exactly optimal for the rational LP has d ≥ 0 exactly, but the
    f32-lowered copy rounds its data by eps_f32 relative, so genuine
    reduced costs can round to ~``eps_f32 * |pi|`` below zero.  The check
    is advisory — every verdict is re-derived by the primal loop and exact
    certification — so disengaging on quantization noise is pure waste.

    Returns (dual_feasible, dmin, tol).
    """
    A64 = np.asarray(A, dtype=np.float64)
    c64 = np.asarray(c, dtype=np.float64)
    B64 = A64[:, basis_full]
    try:
        pi64 = np.linalg.solve(B64.T, c64[basis_full])
    except np.linalg.LinAlgError:
        return False, -np.inf, float(opt_tol)
    d = c64 - pi64 @ A64
    tol = max(
        float(opt_tol),
        32.0 * float(np.finfo(np.float32).eps) * (1.0 + float(np.abs(pi64).max())),
    )
    masked = d[nonbasic_mask]
    dmin = float(masked.min()) if masked.size else 0.0
    return dmin >= -tol, dmin, tol


def _use_host_sparse(provider: MatrixProvider, cfg: SolverConfig) -> bool:
    from relp_tpu.simplex.host_sparse import should_use_host_sparse

    return should_use_host_sparse(provider, cfg)


def _solve_relaxation_once(
    provider: MatrixProvider,
    config: Optional[SolverConfig] = None,
    warm_start_basis: Optional[List[int]] = None,
    mesh=None,
) -> OptimizationResult:
    import jax.numpy as jnp

    from relp_tpu.simplex.engine import make_engine

    cfg = config or default_config()
    engine = make_engine(cfg)
    stats = SolveStats()
    t_start = time.time()
    dtype = _lower_dtype(cfg)

    if mesh is not None and cfg.carry == "df32":
        raise ValueError("carry='df32' is a single-device rescue path")

    problem = lower_provider(
        provider, dtype=dtype, pad_to=cfg.pad_to, equilibrate=cfg.prescale
    )
    A, A_scan, b, c1, c2, candidate_mask = _device_arrays(problem, cfg)
    stats.device_shape = (problem.M, problem.N)

    def apply_mesh(A, A_scan, b, c1, c2, candidate_mask):
        # Column-shard the tableau over the mesh; GSPMD partitions the
        # pricing scans and inserts the cross-device argmax combine.
        from relp_tpu.parallel.sharded import shard_problem

        A, b, c1, mask = shard_problem(mesh, A, b, c1, candidate_mask)
        A_scan2, _, c2s, _ = shard_problem(mesh, A_scan, b, c2, mask)
        return A, A_scan2, b, c1, c2s, mask

    if mesh is not None:
        with mesh:
            A, A_scan, b, c1, c2, candidate_mask = apply_mesh(
                A, A_scan, b, c1, c2, candidate_mask
            )

    warm_started = False
    cold_basis = problem.initial_basis.copy()
    if warm_start_basis is not None:
        assert len(warm_start_basis) == problem.m_real
        warm = cold_basis.copy()
        warm[: problem.m_real] = np.asarray(warm_start_basis, dtype=np.int32)
        problem.initial_basis = warm
        state = engine.init_state(problem, cfg)
        state, residual = engine.refactor(state, A, b, c2, cfg, stats)
        xB = np.asarray(state.xB)
        # 1e-4 is the same breakdown threshold every chunk loop uses; the
        # old 1e-6 gate rejected healthy f32 refactorizations at m>=128.
        basis_ok = np.isfinite(residual) and residual < 1e-4
        if basis_ok and float(xB.min()) > -1e-7:
            warm_started = True
        elif (
            basis_ok
            and cfg.dual_restart
            and mesh is None
            and hasattr(engine, "dual_run_chunk")
        ):
            # Primal infeasible warm basis — the rhs changed since it was
            # optimal (the scenario-resolve case).  If it is still *dual*
            # feasible, dual pivots restore primal feasibility in a few
            # steps with no phase 1.  Beyond reference scope: its warm
            # start (carry/mod.rs:444-478) requires primal feasibility.
            nonbasic = np.asarray(problem.candidate_mask) & ~np.asarray(
                state.in_basis
            )
            dual_feasible, _, _ = warm_dual_feasible(
                A, c2, np.asarray(state.basis), nonbasic, cfg.opt_tol
            )
            restored = False
            if dual_feasible:
                state = _run_dual_phase(
                    engine, state, A_scan, A, b, c2, candidate_mask, cfg,
                    stats,
                )
                if int(state.status) == OPTIMAL:
                    stats.dual_iterations = int(state.iteration)
                    # Hand an already-optimal state to the phase-2 loop,
                    # which re-verifies optimality under the configured
                    # pricing rule (and polishes at full precision).
                    state = state._replace(
                        status=jnp.asarray(RUNNING, jnp.int32)
                    )
                    warm_started = True
                    restored = True
            if not restored:
                # Dual infeasible too, dual budget exhausted, or breakdown:
                # cold start (keeps exact Farkas certification the single
                # source of truth for INFEASIBLE verdicts).
                problem.initial_basis = cold_basis
        else:
            # Infeasible or singular warm basis: cold start.
            problem.initial_basis = cold_basis

    if not warm_started:
        state = engine.init_state(problem, cfg)

    # --- phase 1 (skipped when slack pivots cover every row; reference:
    # FullInitialBasis specialization, two_phase/mod.rs:80-109) ---
    needs_phase1 = not warm_started and bool(
        np.any(problem.initial_basis[: problem.m_real] >= problem.art_offset)
    )
    if needs_phase1:
        state = _run_phase(
            engine, state, problem, A_scan, A, b, c1, candidate_mask, cfg,
            stats, stop_at_zero=True,
        )
        stats.phase1_iterations = int(state.iteration)
        status = int(state.status)
        feasible = float(state.obj) <= cfg.phase1_tol
        if status == SINGULAR:
            return _finish(cfg, stats, t_start, SolveStatus.NUMERICAL_ERROR)
        if status == RUNNING and not feasible:
            return _finish(cfg, stats, t_start, SolveStatus.ITERATION_LIMIT)
        if status == UNBOUNDED:
            # The phase-1 objective (sum of artificials) is bounded below
            # by 0: a ratio test that finds no blocking row here is float
            # noise in the carried inverse, not a real ray.  Route it to
            # the escalation ladder like any other numerical breakdown
            # (seen on SCSD8 under the f32 fast path via the first-order
            # crossover script).
            return _finish(cfg, stats, t_start, SolveStatus.NUMERICAL_ERROR)
        if not feasible:
            phase1_basis = None
            if cfg.certify:
                # Exact Farkas certificate from the phase-1-optimal basis.
                from relp_tpu.exact.certify import certify_infeasible

                basis_np = np.asarray(state.basis)
                phase1_basis = [
                    int(basis_np[i]) for i in range(problem.m_real)
                ]
                _tc = time.time()
                stats.certified = certify_infeasible(
                    problem.provider, phase1_basis, problem.art_offset
                )
                stats.certify_time_s += time.time() - _tc
            result = _finish(
                cfg, stats, t_start, SolveStatus.INFEASIBLE,
                basis=phase1_basis, art_offset=problem.art_offset,
            )
            result.provider = problem.provider  # type: ignore[attr-defined]
            return result

        # Fresh factorization before zero-level drive-out (the LU engine's
        # eta ring may be full at phase end).
        state, _residual = engine.refactor(state, A, b, c1, cfg, stats)
        state, redundant = _drive_out_artificials(
            engine, state, problem, A, b, c1, cfg, stats
        )
        if redundant:
            # Rank repair: rebuild without the redundant rows.
            stats.removed_rows = redundant
            old_basis = np.asarray(state.basis)
            keep = [i for i in range(problem.m_real) if i not in set(redundant)]
            problem = lower_removing_rows(
                problem, redundant, dtype=dtype, pad_to=cfg.pad_to
            )
            new_basis = problem.initial_basis.copy()
            for new_i, old_i in enumerate(keep):
                j = int(old_basis[old_i])
                if j < problem.n_real:
                    new_basis[new_i] = j
            problem.initial_basis = new_basis
            A, A_scan, b, c1, c2, candidate_mask = _device_arrays(problem, cfg)
            stats.device_shape = (problem.M, problem.N)
            state = engine.init_state(problem, cfg)

        # Phase transition: real costs, fresh factorization
        # (reference: from_artificial, non_artificial.rs:151-172).
        state, residual = engine.refactor(state, A, b, c2, cfg, stats)
        if not np.isfinite(residual) or residual > 1e-4:
            return _finish(cfg, stats, t_start, SolveStatus.NUMERICAL_ERROR)
        state = state._replace(status=jnp.asarray(RUNNING, jnp.int32))

    # --- phase 2 ---
    state = _run_phase(
        engine, state, problem, A_scan, A, b, c2, candidate_mask, cfg, stats
    )
    stats.iterations = int(state.iteration)
    status = int(state.status)
    if status == SINGULAR:
        return _finish(cfg, stats, t_start, SolveStatus.NUMERICAL_ERROR)
    if status == RUNNING:
        return _finish(cfg, stats, t_start, SolveStatus.ITERATION_LIMIT)
    if status == UNBOUNDED:
        structural = None
        if cfg.certify:
            from relp_tpu.exact.certify import certify_unbounded

            basis_np = np.asarray(state.basis)
            structural = [int(basis_np[i]) for i in range(problem.m_real)]
            # Zero-level artificials may still be basic; the certifier
            # substitutes them as zero-cost identity columns and requires
            # their exact value to be 0 (no silent certification skip).
            _tc = time.time()
            stats.certified = certify_unbounded(
                problem.provider, structural, art_offset=problem.art_offset
            )
            stats.certify_time_s += time.time() - _tc
        result = _finish(
            cfg, stats, t_start, SolveStatus.UNBOUNDED,
            basis=structural, art_offset=problem.art_offset,
        )
        result.provider = problem.provider  # type: ignore[attr-defined]
        return result

    # --- extract the BFS over provider columns ---
    basis_np = np.asarray(state.basis)
    xB_np = np.asarray(state.xB, dtype=np.float64)
    if hasattr(state, "xB_lo"):  # df32 carry: collapse the hi+lo pair
        xB_np = xB_np + np.asarray(state.xB_lo, dtype=np.float64)
    entries = []
    structural_basis: List[int] = []
    for i in range(problem.m_real):
        j = int(basis_np[i])
        structural_basis.append(j)
        if j < problem.n_real and abs(xB_np[i]) > cfg.zero_tol:
            value = xB_np[i]
            if problem.col_scale is not None:
                value *= problem.col_scale[j]  # undo equilibration
            entries.append((j, value))

    obj_val = float(state.obj) + float(getattr(state, "obj_lo", 0.0))
    result = OptimizationResult(
        status=SolveStatus.FINITE_OPTIMUM,
        bfs=None,
        objective=obj_val,
        basis=structural_basis,
        stats=stats,
    )
    result.float_entries = entries  # type: ignore[attr-defined]
    result.provider = problem.provider  # type: ignore[attr-defined]
    result.removed_rows = stats.removed_rows  # type: ignore[attr-defined]

    if cfg.certify:
        from relp_tpu.exact.certify import certify_and_repair

        _tc = time.time()
        certify_and_repair(result, problem.provider, structural_basis, cfg)
        stats.certify_time_s += time.time() - _tc
    else:
        from fractions import Fraction

        result.bfs = SparseVector(
            [(j, Fraction(float(v))) for j, v in entries],
            problem.n_real,
        )

    stats.wall_time_s = time.time() - t_start
    return result


def _finish(
    cfg: SolverConfig, stats: SolveStats, t_start: float, status: SolveStatus,
    *, basis=None, art_offset=None,
) -> OptimizationResult:
    stats.wall_time_s = time.time() - t_start
    return OptimizationResult(
        status=status, stats=stats, basis=basis, art_offset=art_offset
    )


def solve_general_form(
    general_form, config: Optional[SolverConfig] = None
) -> Tuple[OptimizationResult, Optional[object]]:
    """Full pipeline on a GeneralForm: presolve -> standardize -> solve ->
    reconstruct (the canonical reference pipeline, SURVEY.md 3.1).

    Returns (result, Solution or None).
    """
    from relp_tpu.data.elements import LinearProgramError, LPStatus

    cfg = config or default_config()
    gf = general_form

    if cfg.presolve:
        try:
            gf.presolve()
        except LinearProgramError as exc:
            stats = SolveStats()
            if exc.status is LPStatus.FINITE_OPTIMUM:
                result = OptimizationResult(
                    status=SolveStatus.FINITE_OPTIMUM, stats=stats
                )
                result.stats.certified = True
                solution = exc.payload
                # The presolve-complete payload is in the original sense
                # (standardize never ran); convert to the reported
                # minimize-form convention so maximize problems are
                # consistent with the simplex-solved path.
                from relp_tpu.data.elements import Objective
                from relp_tpu.data.solution import Solution

                if gf.objective is Objective.MAXIMIZE and solution is not None:
                    solution = Solution(
                        -solution.objective_value, solution.solution_values
                    )
                return result, solution
            if exc.status is LPStatus.INFEASIBLE:
                return OptimizationResult(SolveStatus.INFEASIBLE, stats=stats), None
            return OptimizationResult(SolveStatus.UNBOUNDED, stats=stats), None

    # Prescaling is applied inside the device lowering (pow-2 equilibration,
    # invisible to the exact pipeline — see relp_tpu.data.scale).
    counts = gf.standardize()
    matrix_data = gf.derive_matrix_data(counts)
    result = solve_relaxation(matrix_data, cfg)
    if not result.is_optimal():
        return result, None

    reduced = result.exact_bfs if result.exact_bfs is not None else result.bfs
    reduced = matrix_data.reconstruct_solution(reduced)
    solution = gf.compute_full_solution_with_reduced_solution(reduced)
    return result, solution
