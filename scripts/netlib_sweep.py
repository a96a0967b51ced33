"""Sweep all netlib problems and report per-problem outcomes.

Usage:
  JAX_PLATFORMS=cpu python scripts/netlib_sweep.py [--budget SECONDS] [names...]

Writes a JSON report to /tmp/netlib_sweep.json and prints a summary table.
"""

import argparse
import json
import os
import signal
import sys
import time
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

# A checkout of the reference (vandenheuvel/relp): RELP_REFERENCE_ROOT, else
# the git-ignored reference/ inside this checkout.
REFERENCE_ROOT = os.environ.get(
    "RELP_REFERENCE_ROOT", os.path.join(os.path.dirname(__file__), "..", "reference")
)

from netlib_expected import NETLIB_EXPECTED, NETLIB_EXTRA

PROBLEM_DIR = f"{REFERENCE_ROOT}/tests/netlib/problem_files"


class Timeout(Exception):
    pass


def _alarm(signum, frame):
    raise Timeout()


def solve_one(name, budget, cfg_overrides):
    from relp_tpu.config import SolverConfig
    from relp_tpu.io import mps_to_general_form, parse_fixed
    from relp_tpu.simplex import solve_general_form

    path = os.path.join(PROBLEM_DIR, f"{name}.SIF")
    t0 = time.time()
    with open(path) as f:
        mps = parse_fixed(f.read())
    gf = mps_to_general_form(mps)
    parse_s = time.time() - t0
    defaults = dict(pad_to=128, chunk_size=100, refactor_period=100)
    defaults.update(cfg_overrides)
    cfg = SolverConfig(**defaults)
    t1 = time.time()
    result, solution = solve_general_form(gf, cfg)
    solve_s = time.time() - t1
    return result, solution, parse_s, solve_s


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--budget", type=float, default=120.0)
    parser.add_argument("--out", default="/tmp/netlib_sweep.json")
    parser.add_argument("--dtype", default="float64")
    parser.add_argument("--scan-dtype", default="float32")
    parser.add_argument("--refactor", type=int, default=100)
    parser.add_argument("--cleanup-time", type=float, default=None,
                        help="exact_cleanup_time_s override (big instances "
                        "need > the 600s default for certification)")
    parser.add_argument("--cleanup-budget", type=int, default=None,
                        help="exact_cleanup_budget (pivots) override")
    parser.add_argument("--phase1", default="two_phase",
                        help="two_phase | bigm (host backend composite walk)")
    parser.add_argument(
        "--extra",
        action="store_true",
        help="sweep the 54 shipped-but-untested problems (NETLIB_EXTRA)",
    )
    parser.add_argument("names", nargs="*")
    args = parser.parse_args()

    if args.extra:
        names = args.names or sorted(NETLIB_EXTRA)
    else:
        names = args.names or sorted(NETLIB_EXPECTED)
    signal.signal(signal.SIGALRM, _alarm)

    report = {}
    for name in names:
        if name in NETLIB_EXPECTED:
            expected, tol, ignored = NETLIB_EXPECTED[name]
        else:
            # Extra problem: external value may be approximate or absent;
            # exact certification is the hard gate (see netlib_expected.py).
            expected, tol = NETLIB_EXTRA[name]
            ignored = None
        entry = {"expected": expected, "tol": tol, "ignored_in_reference": ignored}
        signal.alarm(int(args.budget))
        t0 = time.time()
        try:
            overrides = dict(
                dtype=args.dtype,
                scan_dtype=args.scan_dtype,
                refactor_period=args.refactor,
                chunk_size=args.refactor,
                phase1=args.phase1,
            )
            if args.cleanup_time is not None:
                overrides["exact_cleanup_time_s"] = args.cleanup_time
            if args.cleanup_budget is not None:
                overrides["exact_cleanup_budget"] = args.cleanup_budget
            result, solution, parse_s, solve_s = solve_one(name, args.budget, overrides)
            entry["status"] = result.status.value
            entry["parse_s"] = round(parse_s, 2)
            entry["solve_s"] = round(solve_s, 2)
            entry["iterations"] = result.stats.iterations
            entry["certified"] = result.stats.certified
            entry["certify_s"] = round(result.stats.certify_time_s, 2)
            entry["cleanup_pivots"] = result.stats.exact_cleanup_pivots
            if solution is not None:
                value = float(solution.objective_value)
                entry["objective"] = value
                if expected is None:
                    # No trusted external value: certification is the gate.
                    entry["pass"] = bool(result.stats.certified)
                else:
                    entry["pass"] = abs(value - expected) < tol
            else:
                entry["pass"] = False
        except Timeout:
            entry["status"] = "timeout"
            entry["pass"] = False
            entry["solve_s"] = round(time.time() - t0, 2)
        except Exception as exc:  # noqa: BLE001 — sweep must survive anything
            entry["status"] = f"error: {type(exc).__name__}: {exc}"
            entry["trace"] = traceback.format_exc()[-1500:]
            entry["pass"] = False
        finally:
            signal.alarm(0)
        report[name] = entry
        # Crash-safe: persist after every problem so a killed shard keeps
        # its finished results (round-4 shard A died at hour 6 with nothing).
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        marker = "PASS" if entry.get("pass") else "FAIL"
        print(
            f"{marker} {name:10s} {entry.get('status','?'):16s} "
            f"obj={entry.get('objective','-')!s:>20s} "
            f"iters={entry.get('iterations','-')!s:>7s} "
            f"t={entry.get('solve_s','-')!s:>8s}s "
            f"certified={entry.get('certified','-')!s:>5s} "
            f"{'(ref-ignored)' if ignored else ''}",
            flush=True,
        )

    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    passed = sum(1 for e in report.values() if e.get("pass"))
    print(f"\n{passed}/{len(report)} passed -> {args.out}")


if __name__ == "__main__":
    main()
