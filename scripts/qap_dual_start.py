"""Exact dual-simplex start for the QAP degenerate-plateau holdouts.

QAP12/QAP15 pin every float phase-1 walk to a flat 200k-pivot degenerate
plateau (all-equality rows, b nonzero on only the 24/30 assignment rows —
see ROADMAP.md for the four recorded negative results).  But their
costs are all >= 0, so the *dual* geometry is benign:

  basis of signed artificial columns  s_i * e_i  (cost 0,
  s_i = -1 where b_i > 0 else +1)    =>   y = 0,  d_j = c_j >= 0

is exactly dual feasible, with exactly b's positive rows primal-infeasible
(x_i = -b_i < 0).  From there :func:`relp_tpu.exact.certify
.exact_dual_cleanup` — exact dual simplex with Bland anti-cycling — walks
straight to an optimal basis without ever touching the primal plateau:
each pivot strictly shrinks the (lexicographic) infeasibility in exact
arithmetic where the float walks stalled on tolerance-sized steps.

A signed artificial still basic at a *positive* value at termination would
mean the relaxation `Ax >= b on that row` was strictly cheaper, which
can't improve a QAP (c >= 0, equality-coupled); the script verifies all
artificials are exactly zero before reporting, so the certificate is for
the real LP.

Usage: python scripts/qap_dual_start.py [--problem QAP12] [--budget-s 7200]
                                        [--pivot-budget 20000]
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


class DualStartProvider:
    """Provider wrapper adding one signed zero-cost artificial per row."""

    def __init__(self, inner):
        self.inner = inner
        self.m = inner.nr_rows()
        self.n0 = inner.nr_columns()
        b = inner.right_hand_side()
        self.signs = [Fraction(-1) if v > 0 else Fraction(1) for v in b]

    def nr_rows(self):
        return self.m

    def nr_constraints(self):
        return self.inner.nr_constraints()

    def nr_columns(self):
        return self.n0 + self.m

    def right_hand_side(self):
        return self.inner.right_hand_side()

    def cost_value(self, j):
        if j >= self.n0:
            return Fraction(0)
        return self.inner.cost_value(j)

    def column(self, j):
        if j >= self.n0:
            from relp_tpu.providers.column import SparseColumn

            i = j - self.n0
            return SparseColumn([(i, self.signs[i])])
        return self.inner.column(j)


def main():
    import logging

    logging.basicConfig(
        level=logging.INFO,
        stream=sys.stderr,
        format="%(asctime)s %(message)s",
    )
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="QAP12")
    ap.add_argument("--budget-s", type=float, default=7200.0)
    ap.add_argument("--pivot-budget", type=int, default=20_000)
    args = ap.parse_args()

    from netlib_expected import NETLIB_EXTRA
    from relp_tpu.config import SolverConfig
    from relp_tpu.exact.certify import exact_cleanup, exact_dual_bounded
    from relp_tpu.io import load_general_form
    from relp_tpu.linalg.sparse import SparseVector

    expected, tol = NETLIB_EXTRA.get(args.problem, (None, None))
    t0 = time.time()
    gf = load_general_form(
        f"{REFERENCE_ROOT}/tests/netlib/problem_files/{args.problem}.SIF"
    )
    gf.presolve()
    counts = gf.standardize()
    md = gf.derive_matrix_data(counts)
    wrapper = DualStartProvider(md)
    m, n0 = wrapper.m, wrapper.n0
    neg = sum(1 for v in md.right_hand_side() if v > 0)
    print(
        f"{args.problem}: m={m} n={n0} (+{m} signed artificials), "
        f"{neg} primal-infeasible rows at the dual-feasible start "
        f"[setup {time.time()-t0:.1f}s]",
        flush=True,
    )

    cfg = SolverConfig(
        exact_cleanup_budget=args.pivot_budget,
        exact_cleanup_time_s=args.budget_s,
    )
    basis = list(range(n0, n0 + m))
    fixed = frozenset(basis)
    t1 = time.time()
    # Stage 1: exact dual simplex on randomly perturbed costs (generic ->
    # strictly monotone dual objective, no degenerate treadmill).
    basis, x, y, pivots, verdict = exact_dual_bounded(
        wrapper, basis, cfg, fixed, perturb_seed=20260820
    )
    walk_s = time.time() - t1
    print(f"dual walk (perturbed costs): {pivots} pivots, {walk_s:.1f}s, "
          f"verdict={verdict}", flush=True)
    if verdict != "optimal":
        print("FAIL (no optimal basis)")
        return 1

    # Stage 2: remove the perturbation — exact primal cleanup on the TRUE
    # costs from the perturbed-optimal (primal feasible) basis; the signed
    # artificials are excluded from entering.
    t2 = time.time()
    basis, x, y, pivots2, optimal = exact_cleanup(
        wrapper, basis, cfg, exclude_cols=fixed
    )
    print(f"perturbation removal: {pivots2} exact primal pivots, "
          f"{time.time()-t2:.1f}s, optimal={optimal}", flush=True)
    if not optimal:
        print("FAIL (true-cost cleanup did not reach optimality)")
        return 1

    bad = [
        (j, v) for j, v in zip(basis, x) if j >= n0 and v != 0
    ]
    if bad:
        print(f"FAIL: {len(bad)} signed artificials basic at nonzero value "
              f"(relaxed optimum != real optimum)")
        return 1

    entries = [
        (j, v) for j, v in zip(basis, x) if j < n0 and v != 0
    ]
    obj = sum(wrapper.cost_value(j) * v for j, v in entries)
    reduced = SparseVector(sorted(entries), n0)
    reduced = md.reconstruct_solution(reduced)
    solution = gf.compute_full_solution_with_reduced_solution(reduced)
    value = float(solution.objective_value)
    ok = expected is None or abs(value - expected) < tol
    print(
        f"{'PASS' if ok else 'FAIL'} {args.problem} objective={value!r} "
        f"(expected {expected} +-{tol}) exact={solution.objective_value} "
        f"std-form c'x={float(obj)} pivots={pivots} "
        f"wall={time.time()-t0:.1f}s certified=True (exact dual simplex: "
        f"primal feasible, duals exact, reduced costs >= 0 by construction)",
        flush=True,
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
