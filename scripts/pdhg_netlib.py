"""PDHG at netlib scale on the device.

Runs the first-order path (restarted reflected-Halpern PDHG -> crossover ->
exact certification) on a large netlib instance and compares wall clock
with the cold exact simplex on the same chip.  The point of the first-order
method is scale: its inner loop is two dense matvecs + projections with no
pivot sequencing, so iterations/s stays high where the simplex path's
per-pivot full-tableau stream becomes the bottleneck.

Usage: python scripts/pdhg_netlib.py [--problem FIT2P] [--tol 1e-6]
                                     [--skip-cold]
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
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

# A checkout of the reference (vandenheuvel/relp): RELP_REFERENCE_ROOT, else
# the git-ignored reference/ inside this checkout.
REFERENCE_ROOT = os.environ.get(
    "RELP_REFERENCE_ROOT", os.path.join(os.path.dirname(__file__), "..", "reference")
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="FIT2P")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--max-iters", type=int, default=200_000)
    ap.add_argument("--chunk", type=int, default=400)
    ap.add_argument("--skip-cold", action="store_true")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_enable_x64", True)

    from netlib_expected import NETLIB_EXPECTED, NETLIB_EXTRA
    from relp_tpu.config import SolverConfig
    from relp_tpu.firstorder.pdhg import solve_first_order
    from relp_tpu.io import load_general_form
    from relp_tpu.simplex import solve_relaxation

    expected = dict(NETLIB_EXTRA).get(args.problem)
    if expected is None:
        e = NETLIB_EXPECTED.get(args.problem)
        expected = (e[0], e[1]) if e else (None, None)

    print(f"device: {jax.devices()[0]}", flush=True)
    t0 = time.time()
    gf = load_general_form(
        f"{REFERENCE_ROOT}/tests/netlib/problem_files/{args.problem}.SIF"
    )
    gf.presolve()
    counts = gf.standardize()
    md = gf.derive_matrix_data(counts)
    print(
        f"{args.problem}: rows={md.nr_rows()} cols={md.nr_columns()} "
        f"(prep {time.time()-t0:.1f}s)",
        flush=True,
    )

    cfg = SolverConfig(pad_to=128, chunk_size=150, refactor_period=150)

    # Stage 1 report: the PDHG phase alone (the crossover below repeats it;
    # the repeat cost is minutes and makes progress visible on hangs).
    t1 = time.time()
    _x, _y, fo_stats = solve_first_order(
        md, cfg, tol=args.tol, max_iters=args.max_iters, chunk=args.chunk,
        crossover=False,
    )
    print(
        f"pdhg phase: iters={fo_stats.iterations} "
        f"{time.time()-t1:.1f}s ({fo_stats.iterations/(time.time()-t1):.0f} "
        f"it/s) residuals p={fo_stats.primal_residual:.2e} "
        f"d={fo_stats.dual_residual:.2e} gap={fo_stats.gap:.2e}",
        flush=True,
    )

    t1 = time.time()
    res_fo = solve_first_order(
        md, cfg, tol=args.tol, max_iters=args.max_iters, chunk=args.chunk
    )
    fo_wall = time.time() - t1
    fo_iters = getattr(res_fo.stats, "first_order_iterations", None)
    print(
        f"first-order path: {res_fo.status.value} certified="
        f"{res_fo.stats.certified} obj={res_fo.objective} "
        f"pdhg_iters={fo_iters} "
        f"simplex_polish_iters={res_fo.stats.iterations} "
        f"certify_s={res_fo.stats.certify_time_s:.1f} wall={fo_wall:.1f}s",
        flush=True,
    )
    if fo_iters:
        print(f"  pdhg throughput ~ {fo_iters / fo_wall:.0f} iters/s "
              f"(incl. crossover+certification in the denominator)",
              flush=True)
    if expected[0] is not None and res_fo.objective is not None:
        ok = abs(float(res_fo.objective) - expected[0]) < (expected[1] or 1.0)
        print(f"  vs external value {expected[0]}: {'PASS' if ok else 'FAIL'}",
              flush=True)

    if not args.skip_cold:
        import dataclasses

        # Fair at-scale baseline: at these sizes the dense device lowering
        # explodes (FIT2P: 2.7 GB f64), so the cold exact baseline is the
        # sparse host backend — the same engine the auto-routing would pick.
        cold_cfg = dataclasses.replace(cfg, backend="host_sparse")
        t2 = time.time()
        res_cold = solve_relaxation(md, cold_cfg)
        cold_wall = time.time() - t2
        print(
            f"cold simplex:     {res_cold.status.value} certified="
            f"{res_cold.stats.certified} obj={res_cold.objective} "
            f"iters={res_cold.stats.iterations} "
            f"certify_s={res_cold.stats.certify_time_s:.1f} "
            f"wall={cold_wall:.1f}s",
            flush=True,
        )
        print(f"speedup (first-order vs cold simplex): "
              f"{cold_wall / fo_wall:.2f}x", flush=True)


if __name__ == "__main__":
    main()
