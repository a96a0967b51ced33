"""Restarted PDHG (PDLP-style) — the modern first-order LP method on a device.

Beyond reference scope: the reference is simplex-only.  First-order LP
solvers (PDLP / cuPDLP / cuPDLPx) are the GPU-era alternative whose whole
inner loop is two matvecs — dense streaming work an accelerator does well: no
sequential pivoting, no basis factorization, trivially sharded, and
arbitrarily batchable.  This implementation follows the PDLP recipe
(Applegate et al. 2021; cuPDLPx refinements):

* **Ruiz equilibration** + Pock–Chambolle diagonal scaling as
  preconditioning (host-side, float — exactness is unaffected: the float
  method only *finds* a point, the exact layer certifies).
* **Primal-dual hybrid gradient** on ``min c'x  s.t.  Ax = b, x >= 0``
  (the framework's standard form — variable bounds are already rows):
  ``x+ = max(x - tau (c - A'y), 0)``, ``y+ = y + sigma (b - A(2x+ - x))``,
  jitted as a ``lax.fori_loop`` chunk of iterations per dispatch.
* **Adaptive restarts to the running average** on KKT-residual decay, with
  PDLP's primal-weight rebalancing between restarts.
* **Crossover + exact finish**: the PDHG point selects an advanced basis
  guess (largest-x columns, greedily completed to full row rank on the
  float matrix); the simplex driver warm-starts from it and the Dixon
  layer certifies the final answer exactly — f32 first-order speed with
  the reference's exact contract on top.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from relp_tpu.config import SolverConfig, default_config


@dataclass
class FirstOrderStats:
    iterations: int = 0
    restarts: int = 0
    primal_residual: float = float("inf")  # ||Ax-b|| / (1+||b||)
    dual_residual: float = float("inf")  # ||(A'y-c)^+|| / (1+||c||)
    gap: float = float("inf")  # |c'x - b'y| / (1+|c'x|+|b'y|)
    wall_time_s: float = 0.0
    converged: bool = False


def ruiz_equilibrate(
    A: np.ndarray, iters: int = 10
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Iterative inf-norm row/column equilibration (Ruiz 2001).

    Returns (A_scaled, d_row, d_col) with A_scaled = D_r A D_c.
    """
    m, n = A.shape
    d_row = np.ones(m)
    d_col = np.ones(n)
    As = A.copy()
    for _ in range(iters):
        r = np.sqrt(np.abs(As).max(axis=1))
        c = np.sqrt(np.abs(As).max(axis=0))
        r[r == 0] = 1.0
        c[c == 0] = 1.0
        As /= r[:, None]
        As /= c[None, :]
        d_row /= r
        d_col /= c
    return As, d_row, d_col


def _power_norm(A, iters: int = 30) -> float:
    """Spectral norm estimate by power iteration on A'A."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.standard_normal(A.shape[1]), dtype=A.dtype)
    for _ in range(iters):
        w = (A @ v) @ A
        nrm = jnp.linalg.norm(w)
        v = w / jnp.maximum(nrm, 1e-30)
    return float(jnp.sqrt(jnp.linalg.norm((A @ v) @ A)))


def _kkt(A, b, c, u, x, y) -> Tuple[float, float, float]:
    """KKT residuals for ``min c'x s.t. Ax=b, 0 <= x <= u`` (u may be inf).

    lambda = c - A'y decomposes onto the box's bound multipliers: columns
    with a finite upper bound absorb either sign, so only unbounded
    columns' negative parts are dual-infeasible; the dual objective is
    ``b'y + sum_{u_j<inf} u_j min(lambda_j, 0)`` (PDLP sec. 2)."""
    import jax.numpy as jnp

    pr = float(jnp.linalg.norm(A @ x - b)) / (1.0 + float(jnp.linalg.norm(b)))
    lam = c - y @ A
    finite_u = jnp.isfinite(u)
    viol = jnp.where(finite_u, 0.0, jnp.maximum(-lam, 0.0))
    du = float(jnp.linalg.norm(viol)) / (1.0 + float(jnp.linalg.norm(c)))
    pobj = float(c @ x)
    dobj = float(
        b @ y
        + jnp.sum(
            jnp.where(finite_u, jnp.where(u > 0, u, 0.0), 0.0)
            * jnp.minimum(lam, 0.0)
        )
    )
    gap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
    return pr, du, gap


def _pdhg_chunk(x, y, ax, ay, k0, tau, sigma, A, b, c, u, *, chunk):
    """Reflected Halpern PDHG (cuPDLPx / Lu-Yang r2HPDHG):
    ``z+ = (k+1)/(k+2) * (2 T(z) - z) + 1/(k+2) * anchor``.
    Returns the advanced state plus the last plain PDHG iterate ``T(z)``
    (the candidate whose KKT residuals are measured).

    Module-level jit (installed below on first use): a per-``pdhg_solve``
    jitted closure would retrace per call — costly when crossover solves
    many same-shape LPs (B&B node families, scenario sweeps)."""
    import jax.numpy as jnp
    from jax import lax

    tau = jnp.asarray(tau, A.dtype)
    sigma = jnp.asarray(sigma, A.dtype)

    def body(i, carry):
        x, y, xt, yt = carry
        g = c - y @ A
        x_t = jnp.clip(x - tau * g, 0.0, u)
        y_t = y + sigma * (b - (2.0 * x_t - x) @ A.T)
        lam = ((k0 + i + 1.0) / (k0 + i + 2.0)).astype(A.dtype)
        x_new = lam * (2.0 * x_t - x) + (1.0 - lam) * ax
        y_new = lam * (2.0 * y_t - y) + (1.0 - lam) * ay
        return x_new, y_new, x_t, y_t

    x, y, x_t, y_t = lax.fori_loop(0, chunk, body, (x, y, x, y))
    return x, y, x_t, y_t


_PDHG_CHUNK_JITTED = None


def _pdhg_chunk_jitted():
    """Lazy singleton jit of :func:`_pdhg_chunk` (jax imports stay lazy)."""
    global _PDHG_CHUNK_JITTED
    if _PDHG_CHUNK_JITTED is None:
        import jax

        _PDHG_CHUNK_JITTED = jax.jit(_pdhg_chunk, static_argnames=("chunk",))
    return _PDHG_CHUNK_JITTED


def pdhg_solve(
    A_np: np.ndarray,
    b_np: np.ndarray,
    c_np: np.ndarray,
    u_np: Optional[np.ndarray] = None,
    *,
    tol: float = 1e-6,
    max_iters: int = 100_000,
    chunk: int = 200,
    dtype=np.float32,
    mesh=None,
    row_axis: Optional[str] = "batch",
    col_axis: Optional[str] = "col",
) -> Tuple[np.ndarray, np.ndarray, FirstOrderStats]:
    """Restarted PDHG on ``min c'x s.t. Ax=b, 0 <= x <= u``; returns
    (x, y, stats).  ``u`` entries may be +inf (default: all +inf).

    The inner chunk is one jitted ``fori_loop`` (two matvecs plus a box
    projection per iteration); the host loop checks KKT residuals on the
    per-chunk candidate and applies PDLP's restart criteria.

    With ``mesh`` the iterated system is 2-D sharded: A rows over
    ``row_axis`` and columns over ``col_axis`` (either may be absent from
    the mesh or ``None`` for 1-D sharding), x/c/u follow the columns,
    y/b the rows.  GSPMD turns the two matvecs into per-shard partial
    products plus cross-device ``psum`` combines — PDHG has *no* sequential
    pivot state, so unlike the simplex carry nothing is replicated and the
    method scales to LPs far beyond one device's memory.  Zero-padding (zero
    rows, zero-width ``u=0`` columns) makes every shard equal-sized; the
    padding is exactly absorbing (padded x stays clipped to 0, padded y
    stays 0 since the padded rows have b=0 and no nonzeros).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    from relp_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    t0 = time.time()
    m, n = A_np.shape
    if u_np is None:
        u_np = np.full(n, np.inf)
    As, d_row, d_col = ruiz_equilibrate(A_np.astype(np.float64))
    # Pock-Chambolle (alpha=1) pass on top of Ruiz: D_r = diag(1/sqrt(row
    # 1-norms)), D_c = diag(1/sqrt(col 1-norms)) — the PDLP default combo.
    r1 = np.sqrt(np.abs(As).sum(axis=1))
    c1 = np.sqrt(np.abs(As).sum(axis=0))
    r1[r1 == 0] = 1.0
    c1[c1 == 0] = 1.0
    As = As / r1[:, None] / c1[None, :]
    d_row = d_row / r1
    d_col = d_col / c1
    bs = (b_np.astype(np.float64) * d_row).astype(dtype)
    cs = (c_np.astype(np.float64) * d_col).astype(dtype)
    # Column scaling D_c maps x_s = x / d_col, so bounds scale as u / d_col.
    us = (u_np.astype(np.float64) / d_col).astype(dtype)
    As = As.astype(dtype)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        ax_r = row_axis if (row_axis in mesh.shape and mesh.shape[row_axis] > 1) else None
        ax_c = col_axis if (col_axis in mesh.shape and mesh.shape[col_axis] > 1) else None
        n_r = mesh.shape[ax_r] if ax_r else 1
        n_c = mesh.shape[ax_c] if ax_c else 1
        m_pad = (-m) % n_r
        n_pad = (-n) % n_c
        if m_pad or n_pad:
            As = np.pad(As, ((0, m_pad), (0, n_pad)))
            bs = np.pad(bs, (0, m_pad))
            cs = np.pad(cs, (0, n_pad))
            # u=0 pins padded primal coordinates at 0 through the clip.
            us = np.pad(us, (0, n_pad))
        A = jax.device_put(jnp.asarray(As), NamedSharding(mesh, P(ax_r, ax_c)))
        b = jax.device_put(jnp.asarray(bs), NamedSharding(mesh, P(ax_r)))
        c = jax.device_put(jnp.asarray(cs), NamedSharding(mesh, P(ax_c)))
        u = jax.device_put(jnp.asarray(us), NamedSharding(mesh, P(ax_c)))
    else:
        A = jnp.asarray(As)
        b = jnp.asarray(bs)
        c = jnp.asarray(cs)
        u = jnp.asarray(us)

    norm_A = max(_power_norm(A), 1e-12)
    step = 0.9 / norm_A
    # Primal weight: tau = step/w, sigma = step*w.
    w = float(np.linalg.norm(cs) / max(np.linalg.norm(bs), 1e-12)) or 1.0
    w = min(max(w, 1e-4), 1e4)

    def run_chunk(x, y, ax, ay, k0, tau, sigma):
        return _pdhg_chunk_jitted()(
            x, y, ax, ay, k0, tau, sigma, A, b, c, u, chunk=chunk
        )

    x = jnp.zeros_like(c)
    y = jnp.zeros_like(b)
    ax, ay = x, y  # Halpern anchor
    k0 = 0.0  # Halpern step counter since last restart
    stats = FirstOrderStats()
    last_restart_res = float("inf")
    best_cand, best_res = (x, y), float("inf")
    res_prev = float("inf")
    x_anchor, y_anchor = x, y

    while stats.iterations < max_iters:
        tau = step / w
        sigma = step * w
        x, y, x_t, y_t = run_chunk(x, y, ax, ay, k0, tau, sigma)
        stats.iterations += chunk
        k0 += chunk

        cand = (x_t, y_t)
        cand_res = _kkt(A, b, c, u, x_t, y_t)
        stats.primal_residual, stats.dual_residual, stats.gap = cand_res
        res = max(cand_res)
        if res < best_res:
            best_cand, best_res = cand, res
        if res <= tol:
            x, y = cand
            stats.converged = True
            break
        # PDLP's three restart criteria (sec. 3.2, on the per-chunk
        # candidate): sufficient decay (beta_sufficient = 0.2), necessary
        # decay + worsening (beta_necessary = 0.8), or an artificially
        # long epoch (0.36 * total iterations).  Restart re-anchors the
        # Halpern schedule at the best candidate of the epoch and
        # rebalances the primal weight from the observed movement.
        sufficient = res <= 0.2 * last_restart_res
        necessary = res <= 0.8 * last_restart_res and res > res_prev
        artificial = k0 >= 0.36 * stats.iterations and k0 > 4 * chunk
        res_prev = res
        if sufficient or necessary or artificial:
            cand, res = best_cand, best_res
            dx = float(jnp.linalg.norm(cand[0] - x_anchor))
            dy = float(jnp.linalg.norm(cand[1] - y_anchor))
            if dx > 1e-12 and dy > 1e-12:
                w = min(max(w * np.sqrt(dy / dx), 1e-4), 1e4)
            x, y = cand
            ax, ay = cand
            x_anchor, y_anchor = cand
            k0 = 0.0
            last_restart_res = res
            best_cand, best_res = cand, res
            res_prev = float("inf")
            stats.restarts += 1

    stats.wall_time_s = time.time() - t0
    # Undo the scaling (original x = D_c x_s, y = D_r y_s), dropping any
    # mesh padding first.
    x_out = np.asarray(x, dtype=np.float64)[:n] * d_col
    y_out = np.asarray(y, dtype=np.float64)[:m] * d_row
    return x_out, y_out, stats


def crossover_basis(A_np: np.ndarray, x: np.ndarray) -> Optional[list]:
    """Advanced basis guess from a PDHG point: greedily pick the
    largest-x columns that keep the basis numerically nonsingular (QR
    rank tracking on the float matrix), completed arbitrarily."""
    m, n = A_np.shape
    order = np.argsort(-np.abs(x))
    chosen: list = []
    basis_mat = np.zeros((m, 0))
    # Greedy rank-revealing selection: a column joins if it enlarges the
    # rank of the chosen set (cheap incremental check via lstsq residual).
    q = np.zeros((m, 0))
    for j in order:
        if len(chosen) == m:
            break
        col = A_np[:, j]
        if np.linalg.norm(col) < 1e-12:
            continue
        r = col - q @ (q.T @ col)
        nr = np.linalg.norm(r)
        if nr > 1e-8 * max(1.0, np.linalg.norm(col)):
            q = np.concatenate([q, (r / nr)[:, None]], axis=1)
            chosen.append(int(j))
    if len(chosen) < m:
        return None
    return chosen


def solve_first_order(
    provider,
    config: Optional[SolverConfig] = None,
    *,
    tol: float = 1e-6,
    max_iters: int = 100_000,
    chunk: int = 200,
    crossover: bool = True,
    mesh=None,
):
    """Solve a provider's LP by restarted PDHG, then (optionally) cross
    over to the exact simplex/certification pipeline.

    ``mesh`` shards the PDHG phase over a device mesh (rows over "batch",
    columns over "col" — see :func:`pdhg_solve`); the crossover/exact
    finish stays single-device (it is small: one warm-started simplex).

    With ``crossover=True`` returns the driver's certified
    :class:`OptimizationResult` (warm-started from the PDHG basis guess;
    an unusable guess falls back to a cold exact solve — correctness never
    depends on the first-order phase).  With ``crossover=False`` returns
    ``(x, y, FirstOrderStats)`` in the provider's column/row space.
    """
    cfg = config or default_config()
    dtype = np.float32 if cfg.dtype == "float32" else np.float64
    A, b, c = provider.to_arrays(dtype=np.float64)
    m = A.shape[0]
    m_s = provider.nr_constraints()

    # Split the standard form's bound rows back into a box: PDHG handles
    # ``0 <= x <= u`` by projection (one clip per iteration), which keeps
    # the iterated system at the structural rows only — dramatically
    # smaller and better conditioned than carrying one equality row (and
    # one slack column) per bound the way the simplex lowering does.
    has_struct = (np.abs(A[:m_s, :]) > 0).any(axis=0)
    cols = np.flatnonzero(has_struct)
    u = np.full(len(cols), np.inf)
    from relp_tpu.providers.base import BoundDirection

    bound_row_of_col = {}
    for idx, j in enumerate(cols):
        r = provider.bound_row_index(int(j), BoundDirection.UPPER)
        if r is not None:
            u[idx] = b[r]
            bound_row_of_col[int(j)] = int(r)
    A_s = A[:m_s, :][:, cols]
    b_s = b[:m_s]
    c_s = c[cols]

    x_s, y_s, stats = pdhg_solve(
        A_s, b_s, c_s, u, tol=tol, max_iters=max_iters, chunk=chunk,
        dtype=dtype, mesh=mesh,
    )
    # Lift back to the full standard form: bound-row slacks s_r = u - x_j.
    x = np.zeros(A.shape[1])
    x[cols] = x_s
    slack_col_of_row = {}
    for j in range(A.shape[1]):
        if has_struct[j]:
            continue
        entries = np.flatnonzero(np.abs(A[:, j]) > 0)
        if len(entries) == 1 and entries[0] >= m_s:
            slack_col_of_row[int(entries[0])] = j
    for j, r in bound_row_of_col.items():
        s = slack_col_of_row.get(r)
        if s is not None:
            x[s] = max(b[r] - x[j], 0.0)
    if not crossover:
        y = np.zeros(m)
        y[:m_s] = y_s
        return x, y, stats

    from relp_tpu.simplex.driver import solve_relaxation

    basis = crossover_basis(A, x)
    # The crossover finish is one warm-started simplex + certification; at
    # first-order scale the DENSE device lowering explodes (FIT2P: 10,500
    # standard-form rows -> a 2.7 GB f64 tableau and ~1 s rank-1 updates),
    # so route huge sparse instances to the sparse host backend regardless
    # of which device ran the PDHG phase.
    finish_cfg = cfg
    if cfg.backend == "auto":
        M = provider.nr_rows()
        N = provider.nr_columns() + M
        nnz = sum(
            len(provider.column(j).entries())
            for j in range(provider.nr_columns())
        )
        if M * N >= 2.5e7 and nnz / (M * provider.nr_columns()) < 0.02:
            import dataclasses

            finish_cfg = dataclasses.replace(cfg, backend="host_sparse")
    result = solve_relaxation(provider, finish_cfg, warm_start_basis=basis)
    result.stats.first_order_iterations = stats.iterations  # type: ignore[attr-defined]
    result.stats.first_order_residual = max(  # type: ignore[attr-defined]
        stats.primal_residual, stats.dual_residual, stats.gap
    )
    return result
