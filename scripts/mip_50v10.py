"""miplib 50v-10 exact branch & bound campaign.

The reference stops at the root relaxation (2879.065687,
the reference's tests/miplib/mod.rs:48-72); here the full exact B&B runs
with GMI + cover cuts, strong branching, rounding dive, RINS, and wide
best-bound waves, reporting the rigorous exact interval.

Usage: python scripts/mip_50v10.py [--nodes N] [--batch 64] [--time S]
                                   [--rins-rounds 3]
"""

import argparse
import os
import sys
import time

if os.environ.get("RELP_STACK_DUMP"):
    import faulthandler

    faulthandler.dump_traceback_later(
        int(os.environ["RELP_STACK_DUMP"]), repeat=True, file=sys.stderr
    )

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# A checkout of the reference (vandenheuvel/relp): RELP_REFERENCE_ROOT, else
# the git-ignored reference/ inside this checkout.
REFERENCE_ROOT = os.environ.get(
    "RELP_REFERENCE_ROOT", os.path.join(os.path.dirname(__file__), "..", "reference")
)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--nodes", type=int, default=256)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--time", type=float, default=2400.0)
    parser.add_argument("--rins-rounds", type=int, default=3)
    parser.add_argument("--rins-nodes", type=int, default=300)
    parser.add_argument("--rins-time", type=float, default=600.0)
    parser.add_argument("--local-branching", type=int, default=10,
                        help="Hamming-ball radius (0 disables)")
    parser.add_argument("--lb-rounds", type=int, default=3)
    parser.add_argument("--gap", type=float, default=0.0)
    args = parser.parse_args()

    import jax

    jax.config.update("jax_enable_x64", True)

    from relp_tpu.config import SolverConfig
    from relp_tpu.io import load_general_form
    from relp_tpu.mip import solve_mip

    print(f"device: {jax.devices()[0]}", flush=True)
    t0 = time.time()
    gf = load_general_form(
        f"{REFERENCE_ROOT}/tests/miplib/problem_files/50v-10.mps"
    )
    cfg = SolverConfig(pad_to=128, chunk_size=150, refactor_period=150)
    res = solve_mip(
        gf,
        cfg,
        batch_width=args.batch,
        node_limit=args.nodes,
        gomory_cuts=8,
        cut_rounds=4,
        cover_cuts=8,
        strong_branching=8,
        dive_rounds=30,
        rins_rounds=args.rins_rounds,
        rins_nodes=args.rins_nodes,
        rins_time_s=args.rins_time,
        local_branching=args.local_branching,
        lb_rounds=args.lb_rounds,
        rel_gap=args.gap,
        time_limit_s=args.time,
    )
    wall = time.time() - t0
    print(f"status:        {res.status.value}", flush=True)
    print(f"root bound:    {res.root_objective} "
          f"({float(res.root_objective or 0):.4f})", flush=True)
    print(f"best bound:    {res.best_bound} "
          f"({float(res.best_bound or 0):.4f}, exact={res.best_bound_exact})",
          flush=True)
    print(f"incumbent:     {res.objective} "
          f"({float(res.objective or 0):.4f})", flush=True)
    print(f"gap:           {None if res.gap is None else float(res.gap):.6f}"
          if res.gap is not None else "gap:           n/a", flush=True)
    print(f"nodes:         {res.nodes_solved} solved, {res.nodes_pruned} "
          f"pruned, limit_hit={res.node_limit_hit}, "
          f"time_hit={res.time_limit_hit}", flush=True)
    print(f"incumbent src: dive={res.dive_incumbent} rins={res.rins_incumbent}"
          f" lb={res.lb_incumbent} "
          f"(rins improvements: {res.rins_improvements}, "
          f"lb improvements: {res.lb_improvements}, "
          f"dive LPs: {res.dive_lps})", flush=True)
    print(f"branch vars:   {res.branch_vars_used}", flush=True)
    print(f"certified:     {res.certified}", flush=True)
    print(f"wall:          {wall:.1f}s", flush=True)
    # True optimum for reference: 3311.17946 (MIPLIB).
    if res.objective is not None and res.best_bound is not None:
        lo, hi = float(res.best_bound), float(res.objective)
        print(f"rigorous interval: [{lo:.4f}, {hi:.4f}] "
              f"(true optimum 3311.17946 {'inside' if lo <= 3311.18 <= hi else 'OUTSIDE'})",
              flush=True)


if __name__ == "__main__":
    main()
