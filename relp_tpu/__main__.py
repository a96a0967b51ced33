"""Command-line interface: solve MPS/SIF files.

The reference keeps its CLI in the companion ``relp-bin`` crate; here it
ships in-tree: ``python -m relp_tpu solve problem.mps``.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="relp_tpu", description="exact LP solver on a JAX accelerator"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    solve = sub.add_parser("solve", help="solve an MPS/SIF file")
    solve.add_argument("path")
    solve.add_argument("--dtype", default=None, choices=["float32", "float64"])
    solve.add_argument(
        "--pricing",
        default=None,
        choices=["dantzig", "steepest", "first", "first_memory"],
    )
    solve.add_argument("--basis-inverse", default=None, choices=["dense", "lu"])
    solve.add_argument("--no-presolve", action="store_true")
    solve.add_argument("--no-certify", action="store_true")
    solve.add_argument("--prescale", action="store_true")
    solve.add_argument("--json", action="store_true", help="machine-readable output")
    solve.add_argument("--save-basis", help="write the optimal basis to this path")
    solve.add_argument(
        "--certificate",
        help="write an exact JSON certificate (optimal point + duals, "
        "Farkas ray, or improving ray) verifiable with "
        "`python -m relp_tpu verify FILE CERT`",
    )
    solve.add_argument("--values", action="store_true", help="print variable values")
    solve.add_argument(
        "--mip",
        action="store_true",
        help="honor MPS integer markers: exact branch & bound over batched "
        "LP relaxations (default: solve the LP relaxation like the "
        "reference)",
    )
    solve.add_argument(
        "--first-order",
        action="store_true",
        help="solve by restarted PDHG (PDLP-style matvec-only method) and "
        "cross over to the exact simplex/certification pipeline",
    )
    solve.add_argument(
        "--fo-tol", type=float, default=1e-6,
        help="first-order KKT tolerance before crossover",
    )
    solve.add_argument("--node-limit", type=int, default=10_000)
    solve.add_argument("--batch-width", type=int, default=16)
    solve.add_argument(
        "--gomory-cuts", type=int, default=8,
        help="max exact root GMI cuts per round (0 disables)",
    )
    solve.add_argument(
        "--cut-rounds", type=int, default=4,
        help="max root GMI cut rounds",
    )
    solve.add_argument(
        "--cover-cuts", type=int, default=8,
        help="max exact knapsack cover cuts at the root (0 disables)",
    )
    solve.add_argument(
        "--branching", default="pseudocost",
        choices=["pseudocost", "most_fractional"],
    )
    solve.add_argument(
        "--strong-branching", type=int, default=8,
        help="root strong-branching candidates, evaluated as one batched "
        "dispatch (0 disables)",
    )
    solve.add_argument(
        "--dive-rounds", type=int, default=30,
        help="root rounding-dive LP budget for the initial incumbent "
        "(0 disables)",
    )
    solve.add_argument(
        "--gap", type=float, default=0.0,
        help="stop once this exact relative optimality gap is proven",
    )
    solve.add_argument(
        "--time-limit", type=float, default=None,
        help="wall-clock budget in seconds for branch & bound",
    )

    verify = sub.add_parser(
        "verify",
        help="independently verify an exact certificate against a file "
        "(pure rational arithmetic, no solver state)",
    )
    verify.add_argument("path", help="the MPS/SIF file the certificate is for")
    verify.add_argument("certificate", help="JSON certificate path")
    verify.add_argument(
        "--no-presolve", action="store_true",
        help="must match the flag the certificate was produced with",
    )

    args = parser.parse_args(argv)

    from relp_tpu.config import SolverConfig
    from relp_tpu.io import load_general_form
    from relp_tpu.simplex import SolveStatus, solve_general_form

    if args.command == "verify":
        from relp_tpu.data.elements import LinearProgramError
        from relp_tpu.exact.certificate import (
            load_certificate,
            verify_certificate,
        )

        gf = load_general_form(args.path)
        if not args.no_presolve:
            try:
                gf.presolve()
            except LinearProgramError:
                print("not verifiable: presolve decides this LP outright")
                return 1
        counts = gf.standardize()
        md = gf.derive_matrix_data(counts)
        ok, reason = verify_certificate(md, load_certificate(args.certificate))
        print(f"{'VERIFIED' if ok else 'REJECTED'}: {reason}")
        return 0 if ok else 1

    overrides = {}
    if args.dtype:
        overrides["dtype"] = args.dtype
    if args.pricing:
        overrides["pricing"] = args.pricing
    if args.basis_inverse:
        overrides["basis_inverse"] = args.basis_inverse
    if args.no_presolve:
        overrides["presolve"] = False
    if args.no_certify:
        overrides["certify"] = False
    if args.prescale:
        overrides["prescale"] = True
    cfg = SolverConfig(**overrides)

    gf = load_general_form(args.path)
    if args.mip:
        if args.certificate:
            print(
                "certificate: --certificate applies to LP solves only "
                "(a MIP verdict is certified through its exact B&B tree, "
                "not a single dual witness); no file written",
                file=sys.stderr,
            )
        from relp_tpu.mip import solve_mip

        mip = solve_mip(
            gf, cfg, batch_width=args.batch_width,
            node_limit=args.node_limit, gomory_cuts=args.gomory_cuts,
            cut_rounds=args.cut_rounds, cover_cuts=args.cover_cuts,
            branching=args.branching,
            strong_branching=args.strong_branching,
            dive_rounds=args.dive_rounds,
            rel_gap=args.gap, time_limit_s=args.time_limit,
        )
        payload = {
            "status": mip.status.value,
            "objective": str(mip.objective) if mip.objective is not None else None,
            "objective_float": (
                float(mip.objective) if mip.objective is not None else None
            ),
            "certified": mip.certified,
            "nodes_solved": mip.nodes_solved,
            "nodes_pruned": mip.nodes_pruned,
            "node_limit_hit": mip.node_limit_hit,
            "time_limit_hit": mip.time_limit_hit,
            "best_bound": (
                str(mip.best_bound) if mip.best_bound is not None else None
            ),
            "gap": str(mip.gap) if mip.gap is not None else None,
            "root_objective": (
                str(mip.root_objective)
                if mip.root_objective is not None
                else None
            ),
        }
        if args.json:
            if args.values and mip.solution is not None:
                payload["values"] = {
                    name: str(value)
                    for name, value in mip.solution.solution_values
                }
            print(json.dumps(payload))
        else:
            for key, value in payload.items():
                print(f"{key}: {value}")
            if args.values and mip.solution is not None:
                for name, value in mip.solution.solution_values:
                    if value:
                        print(f"  {name} = {value}")
        return 0 if mip.status is SolveStatus.FINITE_OPTIMUM else 1
    if args.first_order:
        from relp_tpu.data.elements import LinearProgramError, LPStatus
        from relp_tpu.firstorder import solve_first_order

        solution = None
        try:
            if cfg.presolve:
                gf.presolve()
            counts = gf.standardize()
            md = gf.derive_matrix_data(counts)
            result = solve_first_order(md, cfg, tol=args.fo_tol)
            if result.is_optimal():
                reduced = (
                    result.exact_bfs
                    if result.exact_bfs is not None
                    else result.bfs
                )
                reduced = md.reconstruct_solution(reduced)
                solution = gf.compute_full_solution_with_reduced_solution(
                    reduced
                )
        except LinearProgramError as exc:
            from relp_tpu.simplex.result import (
                OptimizationResult,
                SolveStats,
            )

            status = {
                LPStatus.FINITE_OPTIMUM: SolveStatus.FINITE_OPTIMUM,
                LPStatus.INFEASIBLE: SolveStatus.INFEASIBLE,
                LPStatus.UNBOUNDED: SolveStatus.UNBOUNDED,
            }[exc.status]
            result = OptimizationResult(status=status, stats=SolveStats())
            result.stats.certified = exc.status is LPStatus.FINITE_OPTIMUM
            solution = exc.payload
    else:
        result, solution = solve_general_form(gf, cfg)

    if args.save_basis and result.basis and result.is_optimal():
        # Only optimal bases are valid warm starts: INFEASIBLE/UNBOUNDED
        # results carry phase-1/final bases that may contain artificial
        # indices meaningless to a fresh lowering.
        from relp_tpu.utils.checkpoint import save_basis

        save_basis(args.save_basis, result.basis, {"path": args.path})

    if args.certificate:
        provider = getattr(result, "provider", None)
        if provider is None or not result.stats.certified:
            print(
                "certificate: not exported (presolve decided the LP outright "
                "or the verdict is uncertified)",
                file=sys.stderr,
            )
        else:
            from relp_tpu.exact.certificate import (
                export_certificate,
                save_certificate,
            )

            save_certificate(
                args.certificate, export_certificate(result, provider)
            )

    if args.json:
        payload = {
            "status": result.status.value,
            "objective": (
                str(solution.objective_value) if solution is not None else None
            ),
            "objective_float": (
                float(solution.objective_value) if solution is not None else None
            ),
            "certified": result.stats.certified,
            "iterations": result.stats.iterations,
            "phase1_iterations": result.stats.phase1_iterations,
            "wall_time_s": round(result.stats.wall_time_s, 3),
            "stats": {
                "chunks": result.stats.chunks,
                "refactorizations": result.stats.refactorizations,
                "host_refactors": result.stats.host_refactors,
                "escalations": result.stats.escalations,
                "exact_cleanup_pivots": result.stats.exact_cleanup_pivots,
                "certify_time_s": result.stats.certify_time_s,
                "device_shape": result.stats.device_shape,
            },
        }
        if args.values and solution is not None:
            payload["values"] = {
                name: str(value) for name, value in solution.solution_values
            }
        print(json.dumps(payload))
    else:
        print(f"status:     {result.status.value}")
        if solution is not None:
            print(
                f"objective:  {solution.objective_value} "
                f"(~{float(solution.objective_value):.10g})"
            )
        print(f"certified:  {result.stats.certified}")
        print(
            f"iterations: {result.stats.iterations} "
            f"(phase 1: {result.stats.phase1_iterations})"
        )
        print(f"time:       {result.stats.wall_time_s:.3f}s")
        if args.values and solution is not None:
            for name, value in solution.solution_values:
                if value:
                    print(f"  {name} = {value}")

    return 0 if result.status is SolveStatus.FINITE_OPTIMUM else 1


if __name__ == "__main__":
    sys.exit(main())
