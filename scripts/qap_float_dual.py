"""Hybrid float-dual + exact finish for the QAP plateau holdouts.

The QAP12/QAP15 LP relaxations defeat primal phase 1 (flat 200k-pivot
degenerate plateau, four recorded negatives in ROADMAP.md) and a pure
exact dual walk is sound but slow (QAP8 needs ~12k exact pivots at
~0.2 s each).  The scalable recipe is three stages:

1. **Float dual simplex** on the dense engine from a *signed-artificial*
   basis: all-equality rows with c >= 0 make y = 0 / d = c >= 0 exactly
   dual feasible, and flipping the artificial sign on b>0 rows turns the
   required pivots into standard lower-violation dual steps the existing
   ``dual_run_chunk`` kernel performs at device speed.  Float costs get a
   deterministic tiny perturbation so the (integer-cost) dual ties don't
   freeze the walk; correctness never depends on this stage.
2. **Exact bounded dual walk** (`exact_dual_bounded`, perturbed costs)
   repairs what floats got wrong — leftover exact negatives and any fixed
   artificial parked at a nonzero value.
3. **Exact primal cleanup** on the TRUE costs removes the perturbation;
   the certificate (primal feasibility + nonnegative reduced costs over
   the real columns) is exact end to end.

Usage: python scripts/qap_float_dual.py [--problem QAP12] [--budget-s 7200]
"""

import argparse
import os
import sys
import time
from fractions import Fraction

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

# A checkout of the reference (vandenheuvel/relp): RELP_REFERENCE_ROOT, else
# the git-ignored reference/ inside this checkout.
REFERENCE_ROOT = os.environ.get(
    "RELP_REFERENCE_ROOT", os.path.join(os.path.dirname(__file__), "..", "reference")
)

import numpy as np

from qap_dual_start import DualStartProvider  # noqa: E402


def main():
    import logging

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="QAP12")
    ap.add_argument("--budget-s", type=float, default=7200.0)
    ap.add_argument("--pivot-budget", type=int, default=50_000)
    ap.add_argument("--chunk", type=int, default=500)
    ap.add_argument("--max-float-iters", type=int, default=2_000_000)
    args = ap.parse_args()

    import jax

    # x64 enables the f64-emulated carry-health gate (engine._carry_health);
    # without it every chunk exit at m>=3200 pays a ~4 s host LAPACK
    # inversion because the f32 residual floor sits just above the gate.
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from netlib_expected import NETLIB_EXTRA
    from relp_tpu.config import SolverConfig
    from relp_tpu.exact.certify import exact_cleanup, exact_dual_bounded
    from relp_tpu.io import load_general_form
    from relp_tpu.linalg.sparse import SparseVector
    from relp_tpu.simplex.engine import DenseEngine
    from relp_tpu.simplex.lowering import lower_provider
    from relp_tpu.simplex.result import SolveStats
    from relp_tpu.simplex.state import RUNNING

    expected, tol = NETLIB_EXTRA.get(args.problem, (None, None))
    on_cpu = jax.default_backend() == "cpu"
    t0 = time.time()
    gf = load_general_form(
        f"{REFERENCE_ROOT}/tests/netlib/problem_files/{args.problem}.SIF"
    )
    gf.presolve()
    counts = gf.standardize()
    md = gf.derive_matrix_data(counts)
    problem = lower_provider(md, pad_to=128)
    m_real, n_real = problem.m_real, problem.n_real
    art = problem.art_offset
    b_np = np.asarray(problem.b, dtype=np.float64)
    signs = np.ones(problem.M)
    for i in range(m_real):
        if b_np[i] > 0:
            signs[i] = -1.0
            problem.A[i, art + i] = -1.0
    problem.initial_basis = np.arange(art, art + problem.M, dtype=np.int32)
    print(
        f"{args.problem}: M={problem.M} N={problem.N} (real {m_real}x"
        f"{n_real}), {int((signs < 0).sum())} flipped artificials, "
        f"backend={jax.default_backend()} [setup {time.time()-t0:.1f}s]",
        flush=True,
    )

    cfg = SolverConfig(
        dtype="float64" if on_cpu else "float32",
        pad_to=128,
        chunk_size=args.chunk,
        refactor_period=args.chunk,
        max_iterations=args.max_float_iters,
        exact_cleanup_budget=args.pivot_budget,
        exact_cleanup_time_s=args.budget_s,
    )
    engine = DenseEngine()
    state = engine.init_state(problem, cfg)
    dtype = state.Binv.dtype
    state = state._replace(
        Binv=jnp.asarray(np.diag(signs), dtype=dtype),
        xB=jnp.asarray(signs * b_np, dtype=dtype),
        pi=jnp.zeros(problem.M, dtype=dtype),
        obj=jnp.zeros((), dtype=dtype),
    )

    # Deterministic tiny cost perturbation for the float walk only: QAP
    # costs are small integers, so dual ratio ties are exact even in f64
    # and freeze the walk the same way they froze the exact one.
    rng = np.random.default_rng(20260820)
    c2 = np.asarray(problem.c_phase2, dtype=np.float64)
    scale = max(1.0, float(np.abs(c2).max()))
    c2p = c2 + 1e-7 * scale * rng.random(problem.N)
    c2p[~problem.candidate_mask] = 0.0
    A = jnp.asarray(problem.A, dtype=dtype)
    bj = jnp.asarray(b_np, dtype=dtype)
    cj = jnp.asarray(c2p, dtype=dtype)
    mask = jnp.asarray(problem.candidate_mask)

    stats = SolveStats()
    t1 = time.time()
    chunks = 0
    flip_rounds = 0
    out_of_budget = False
    best_obj = -np.inf
    stall = time.time()
    while True:
        # Inner loop: dual pivots to a terminal state.
        while True:
            state = engine.dual_run_chunk(state, A, A, cj, mask, cfg)
            chunks += 1
            status = int(state.status)
            if status != RUNNING:
                break
            state, residual = engine.refactor(state, A, bj, cj, cfg, stats)
            if not np.isfinite(residual) or residual > 1e-4:
                print(f"float dual: refactor breakdown (res {residual})")
                break
            # f32 noise eventually caps the dual objective climb: once the
            # walk oscillates without improvement for minutes (NOT a mere
            # degenerate stretch — those clear in seconds at chunk speed),
            # hand the basis to the exact tail instead of grinding the
            # noise floor.
            obj_now = float(state.obj)
            if obj_now > best_obj + 1e-3 * (1.0 + abs(best_obj)):
                best_obj = obj_now
                stall = time.time()
            elif time.time() - stall > 240.0:
                print(
                    f"float dual: no progress for {time.time()-stall:.0f}s "
                    f"at obj {obj_now:.4f} — handing basis to exact tail"
                )
                out_of_budget = True
                break
            if chunks % 20 == 0:
                n_neg = int((np.asarray(state.xB) < -1e-9).sum())
                print(
                    f"  float dual: {int(state.iteration)} pivots, "
                    f"obj {float(state.obj):.4f}, {n_neg} negatives, "
                    f"{time.time()-t1:.0f}s",
                    flush=True,
                )
            if int(state.iteration) >= cfg.max_iterations:
                break
            if time.time() - t1 > args.budget_s / 2:
                print("float dual: budget half spent, taking current basis")
                out_of_budget = True
                break
        # Bound-flip rounds: the dual kernel only leaves x < 0 rows, so a
        # FIXED artificial parked at a positive value (upper violation of
        # its [0,0] interval) is invisible to it.  Flip that column's sign
        # (the degenerate-interval bound flip of bounded dual simplex):
        # its basic value negates, the kernel engages, and — because the
        # candidate mask bars artificials from ever entering — each
        # artificial flips at most once, so this terminates.
        xB_np = np.asarray(state.xB)
        bas_np = np.asarray(state.basis)
        pos_art = [
            i
            for i in range(problem.M)
            if bas_np[i] >= art and xB_np[i] > 1e-9
        ]
        if not pos_art or out_of_budget or flip_rounds >= 60:
            break
        flip_rounds += 1
        Binv_np = np.asarray(state.Binv).copy()
        for i in pos_art:
            j = int(bas_np[i])
            problem.A[:, j] *= -1.0
            # (B S)^-1 = S B^-1: flipping basis column i flips ROW i of
            # the carried inverse; xB negates there; pi/obj unchanged
            # (the flipped columns are zero-cost artificials).
            Binv_np[i, :] *= -1.0
            xB_np = xB_np.copy()
            xB_np[i] *= -1.0
        A = jnp.asarray(problem.A, dtype=dtype)
        state = state._replace(
            Binv=jnp.asarray(Binv_np, dtype=dtype),
            xB=jnp.asarray(xB_np, dtype=dtype),
            status=jnp.asarray(RUNNING, jnp.int32),
        )
        print(
            f"  flip round {flip_rounds}: {len(pos_art)} positive "
            f"artificials flipped, obj {float(state.obj):.4f}",
            flush=True,
        )
        # A flip restarts the climb from a lower objective; reset the
        # stall tracker so the post-flip ascent is not mistaken for noise.
        best_obj = -np.inf
        stall = time.time()
    n_neg = int((np.asarray(state.xB) < -1e-9).sum())
    print(
        f"float dual: status={int(state.status)} pivots="
        f"{int(state.iteration)} obj={float(state.obj):.4f} "
        f"negatives={n_neg} flip_rounds={flip_rounds} "
        f"[{time.time()-t1:.1f}s]",
        flush=True,
    )

    # Map the device basis to the exact wrapper's column space.
    wrapper = DualStartProvider(md)
    n0 = wrapper.n0
    dev_basis = np.asarray(state.basis)
    basis = []
    for i in range(m_real):
        j = int(dev_basis[i])
        basis.append(j if j < n_real else n0 + (j - art))
    fixed = frozenset(range(n0, n0 + m_real))

    cfg_exact = SolverConfig(
        exact_cleanup_budget=args.pivot_budget,
        exact_cleanup_time_s=max(1.0, args.budget_s - (time.time() - t0)),
    )
    t2 = time.time()
    basis, x, y, pivots, verdict = exact_dual_bounded(
        wrapper, basis, cfg_exact, fixed, perturb_seed=20260820,
        lift_costs=True,
    )
    print(f"exact dual tail: {pivots} pivots, {time.time()-t2:.1f}s, "
          f"verdict={verdict}", flush=True)
    if verdict != "optimal":
        print("FAIL (exact dual tail gave up)")
        return 1

    t3 = time.time()
    basis, x, y, pivots2, optimal = exact_cleanup(
        wrapper, basis, cfg_exact, exclude_cols=fixed
    )
    print(f"perturbation removal: {pivots2} exact primal pivots, "
          f"{time.time()-t3:.1f}s, optimal={optimal}", flush=True)
    if not optimal:
        print("FAIL (true-cost cleanup did not reach optimality)")
        return 1
    bad = [(j, v) for j, v in zip(basis, x) if j >= n0 and v != 0]
    if bad:
        print(f"FAIL: {len(bad)} artificials basic at nonzero value")
        return 1

    entries = [(j, v) for j, v in zip(basis, x) if j < n0 and v != 0]
    reduced = SparseVector(sorted(entries), n0)
    reduced = md.reconstruct_solution(reduced)
    solution = gf.compute_full_solution_with_reduced_solution(reduced)
    value = float(solution.objective_value)
    ok = expected is None or abs(value - expected) < tol
    print(
        f"{'PASS' if ok else 'FAIL'} {args.problem} objective={value!r} "
        f"(expected {expected} +-{tol}) exact={solution.objective_value} "
        f"wall={time.time()-t0:.1f}s certified=True "
        f"(exact primal-feasible basis, exact nonnegative reduced costs)",
        flush=True,
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
