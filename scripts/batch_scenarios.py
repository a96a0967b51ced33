"""Scenario-batch demo: many perturbed netlib LPs solved in lockstep.

One of the BASELINE configs ("perturbed Netlib instances vmapped per chip"):
loads a netlib problem, builds N scenarios with rationally perturbed rhs,
solves them all with the vmapped batch driver on one device, and reports
throughput + exact certification counts.

Usage: python scripts/batch_scenarios.py [--problem ADLITTLE] [--batch 256]
"""

import argparse
import copy
import os
import sys
import time
from fractions import Fraction

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# A checkout of the reference (vandenheuvel/relp): RELP_REFERENCE_ROOT, else
# the git-ignored reference/ inside this checkout.
REFERENCE_ROOT = os.environ.get(
    "RELP_REFERENCE_ROOT", os.path.join(os.path.dirname(__file__), "..", "reference")
)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--problem", default="ADLITTLE")
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--certify", type=int, default=0,
                        help="exactly certify this many scenarios; 0 (the "
                             "default) certifies EVERY scenario — sampling "
                             "is an explicit opt-out and is reported as "
                             "'sampled' in the summary line")
    parser.add_argument("--device-cadence", action="store_true",
                        help="run the refactorization cadence inside the "
                             "jitted chunk (batched_run_chunk refactor_"
                             "period) so one dispatch carries --chunk pivots")
    parser.add_argument("--chunk", type=int, default=150,
                        help="pivots per dispatch (with --device-cadence "
                             "this may exceed the 150-pivot refactor period)")
    parser.add_argument("--warm", action="store_true",
                        help="solve the unperturbed base once, then dual-"
                             "warm-restart every scenario from its optimal "
                             "basis (skips both phases)")
    parser.add_argument("--repeat", action="store_true",
                        help="solve a SECOND fresh scenario family in the "
                             "same process and report its timing too — the "
                             "steady-state number with all shapes compiled "
                             "(different rhs values)")
    args = parser.parse_args()

    import jax

    jax.config.update("jax_enable_x64", True)

    from relp_tpu.config import SolverConfig
    from relp_tpu.io import mps_to_general_form, parse_fixed
    from relp_tpu.parallel.batch_driver import solve_batch
    from relp_tpu.simplex.result import SolveStatus

    path = f"{REFERENCE_ROOT}/tests/netlib/problem_files/{args.problem}.SIF"
    base = mps_to_general_form(parse_fixed(open(path).read()))
    base.presolve()
    counts = base.standardize()

    print(f"device: {jax.devices()[0]}", flush=True)
    print(f"base problem: {base}", flush=True)

    def build_family(salt):
        providers = []
        for s in range(args.batch):
            gf = copy.deepcopy(base)
            # Rational rhs perturbation: +/- up to 1% in exact arithmetic.
            for i in range(len(gf.b)):
                wobble = Fraction(
                    (s * 7919 + i * 104729 + salt * 31) % 2001 - 1000, 100_000
                )
                gf.b[i] = gf.b[i] * (1 + wobble)
            providers.append(gf.derive_matrix_data(counts))
        return providers

    t0 = time.time()
    providers = build_family(0)
    build_s = time.time() - t0

    cfg = SolverConfig(
        pad_to=128, chunk_size=args.chunk, refactor_period=150,
        device_refactor=args.device_cadence,
    )
    warm_basis = None
    if args.warm:
        from relp_tpu.simplex import solve_relaxation

        t0 = time.time()
        base_result = solve_relaxation(base.derive_matrix_data(counts), cfg)
        print(
            f"base solve: {base_result.status.name.lower()} in "
            f"{time.time()-t0:.1f}s ({base_result.stats.iterations} pivots)",
            flush=True,
        )
        warm_basis = base_result.basis
    t0 = time.time()
    results = solve_batch(
        providers, cfg, certify=False, shared_structure=True,
        warm_start_basis=warm_basis,
    )
    solve_s = time.time() - t0

    optimal = sum(r.status is SolveStatus.FINITE_OPTIMUM for r in results)
    infeasible = sum(r.status is SolveStatus.INFEASIBLE for r in results)
    # Batch-extracted results have stats.chunks == 0; fallbacks went through
    # the single-LP driver.
    fallbacks = sum(r.stats.chunks > 0 for r in results)
    total_pivots = sum(r.stats.iterations for r in results)
    if args.warm:
        dual_pivots = sum(r.stats.dual_iterations for r in results)
        print(
            f"warm restarts: {dual_pivots} dual pivots across the batch "
            f"(phase 1 skipped)",
            flush=True,
        )
    print(
        f"batch={args.batch}: {optimal} optimal, {infeasible} infeasible, "
        f"{args.batch - optimal - infeasible} other, {fallbacks} fallbacks",
        flush=True,
    )
    print(
        f"build {build_s:.1f}s, solve {solve_s:.1f}s "
        f"({total_pivots} pivots, {total_pivots / solve_s:.0f} pivots/s, "
        f"{args.batch / solve_s:.1f} LPs/s)",
        flush=True,
    )

    if args.repeat:
        providers2 = build_family(1)
        t0 = time.time()
        results2 = solve_batch(
            providers2, cfg, certify=False, shared_structure=True,
            warm_start_basis=warm_basis,
        )
        solve2_s = time.time() - t0
        optimal2 = sum(
            r.status is SolveStatus.FINITE_OPTIMUM for r in results2
        )
        pivots2 = sum(r.stats.iterations for r in results2)
        fallbacks2 = sum(r.stats.chunks > 0 for r in results2)
        print(
            f"steady-state (fresh family, shapes compiled): solve "
            f"{solve2_s:.1f}s ({pivots2} pivots, "
            f"{pivots2 / solve2_s:.0f} pivots/s, "
            f"{args.batch / solve2_s:.1f} LPs/s; {optimal2} optimal, "
            f"{fallbacks2} fallbacks)",
            flush=True,
        )

    # Exactly certify on the host — EVERY scenario by default (the exactness
    # contract of the single-LP path holds for the batch path too); a
    # positive --certify opts into sampling and says so in the summary.
    from relp_tpu.exact.certify import certify_and_repair

    certified = 0
    escalated = 0
    t0 = time.time()
    if args.certify > 0:
        sample = [
            k
            for k in range(0, args.batch, max(1, args.batch // args.certify))
        ][: args.certify]
        label = "sampled scenarios"
    else:
        sample = list(range(args.batch))
        label = "scenarios (total)"
    for k in sample:
        r = results[k]
        if r.status is SolveStatus.FINITE_OPTIMUM and r.basis:
            if r.stats.certified:
                certified += 1  # fallback path already certified it
                continue
            certify_and_repair(
                r,
                providers[k],
                r.basis,
                cfg,
                art_offset=providers[k].nr_columns(),
            )
            if not r.stats.certified:
                # The f32 batch basis was not exactly optimal: run the full
                # single-LP pipeline (escalation + exact cleanup) as a user
                # would.
                from relp_tpu.simplex import solve_relaxation

                r2 = solve_relaxation(
                    providers[k], cfg, warm_start_basis=r.basis
                )
                escalated += 1
                certified += r2.stats.certified
            else:
                certified += 1
        elif r.status is SolveStatus.INFEASIBLE and r.stats.certified:
            certified += 1  # exact Farkas certificate from the fallback
    print(
        f"certified {certified}/{len(sample)} {label} exactly "
        f"({escalated} needed escalation; {time.time()-t0:.1f}s)",
        flush=True,
    )


if __name__ == "__main__":
    main()
