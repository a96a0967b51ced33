"""Netlib integration gates — the full reference suite, pytest-parametrized.

Mirror of the reference's ``tests/netlib`` harness (mod.rs:46-70 + test.rs):
parse_fixed -> GeneralForm -> presolve -> standardize -> MatrixData -> solve
-> reconstruct, asserting |objective - expected| < tol with the expected
values the reference sources from Gurobi / CLP / GLPK / Koch.

Every problem in ``netlib_expected.NETLIB_EXPECTED`` is gated here (the
reference gates 36 of 48 in CI and #[ignore]s 12 as too slow for exact
single-core arithmetic); problems slower than ~20 s on the CPU backend run
only with ``RELP_TPU_RUN_SLOW=1``.  A presolve/kernel regression in any
default-on problem therefore fails ``pytest tests/``.

Problem files are read from the read-only reference mount.
"""

import os

import pytest

from tests.conftest import reference_problem
from tests.netlib_expected import NETLIB_EXPECTED
from relp_tpu.config import SolverConfig
from relp_tpu.io import mps_to_general_form, parse_fixed
from relp_tpu.simplex import SolveStatus, solve_general_form

# Problems slower than ~20 s on the CPU backend; default-off to keep
# `pytest tests/` fast, on under RELP_TPU_RUN_SLOW=1.  Timings re-measured
# round 2 with peeled exact certification + the sparse host backend
# (80BAU3B previously could not finish on CPU at all; now ~33 s).
SLOW = {
    "25FV47": "~45 s",
    "80BAU3B": "~33 s (sparse host backend + peeled certification)",
    "BNL2": "~110 s",
    "CYCLE": "~70 s",
    "GREENBEA": "~300 s",
    "GREENBEB": "~250 s",
}

RUN_SLOW = bool(os.environ.get("RELP_TPU_RUN_SLOW"))


def solve_netlib(name: str, **cfg_overrides):
    path = reference_problem("netlib", name)
    with open(path) as f:
        mps = parse_fixed(f.read())
    gf = mps_to_general_form(mps)
    defaults = dict(pad_to=64, chunk_size=100, refactor_period=100)
    defaults.update(cfg_overrides)
    cfg = SolverConfig(**defaults)
    return solve_general_form(gf, cfg)


def check_netlib(name: str, expected: float, tol: float, **cfg_overrides):
    result, solution = solve_netlib(name, **cfg_overrides)
    assert result.status is SolveStatus.FINITE_OPTIMUM, result.status
    assert solution is not None
    value = float(solution.objective_value)
    assert abs(value - expected) < tol, (
        f"{name}: got {value}, expected {expected} (certified: "
        f"{result.stats.certified}, iters {result.stats.iterations})"
    )
    return result


@pytest.mark.parametrize("name", sorted(NETLIB_EXPECTED))
def test_netlib(name):
    if name in SLOW and not RUN_SLOW:
        pytest.skip(f"slow on CPU ({SLOW[name]}); set RELP_TPU_RUN_SLOW=1")
    expected, tol, _ignored = NETLIB_EXPECTED[name]
    # The sweep-validated configuration (scripts/netlib_sweep.py defaults):
    # f64 carry + f32 scans, refactor/chunk cadence 100.
    check_netlib(
        f"{name}.SIF",
        expected,
        tol,
        pad_to=128,
        dtype="float64",
        scan_dtype="float32",
    )


def test_afiro_certified():
    """AFIRO end-to-end on the default f32 fast path must exactly certify."""
    result = check_netlib("AFIRO.SIF", -4.6475314286e02, 1e-4)
    assert result.stats.certified


# --- the 54 shipped-but-reference-untested problems (NETLIB_EXTRA) ---
# The reference ships 104 SIF files but writes tests for only 48
# (tests/netlib/problem_files vs tests/netlib/test.rs); these gate the other
# 54.  External values (Koch 2004 / netlib README) are a sanity cross-check;
# the HARD gate is our exact rational certification.  Timings from the
# round-3 CPU sweeps (docs/results/netlib_extra_r3.txt).
EXTRA_SLOW = {
    "CRE-C": "~60 s", "D2Q06C": "~300 s", "D6CUBE": "~35 s",
    "DEGEN3": "~42 s", "DFL001": "~1400 s (uncertified float pass; "
    "certification gap tracked in docs/results)", "FORPLAN": "~40 s",
    "GANGES": "~78 s", "GROW22": "~40 s", "KEN-11": "~1400 s",
    "MAROS": "~36 s", "NESM": "~100 s", "PDS-06": "~47 s",
    "PEROLD": "~75 s", "PILOT": "~1100 s", "PILOT-JA": "~86 s",
    "PILOT-WE": "~58 s", "PILOT87": "~280 s", "PILOTNOV": "~46 s",
    "QAP8": "~90 s", "SCFXM2": "~20 s", "SCFXM3": "~55 s", "SCSD8": "~22 s",
    "SCTAP2": "~32 s", "SCTAP3": "~76 s", "SEBA": "~21 s",
    "SHIP12L": "~22 s", "STOCFOR2": "~140 s", "TRUSS": "~134 s",
    "WOOD1P": "~790 s", "WOODW": "~33 s", "FIT2P": "~1500 s",
    "STOCFOR3": "needs > 1800 s",
}
# Degenerate-plateau holdouts: QAP12/QAP15 LP relaxations pin the float
# phase-1 walk to a massive degenerate plateau (200k Bland pivots at a flat
# objective); tracked in ROADMAP.md.
EXTRA_OPEN = {"QAP12", "QAP15"}
# (r4: the DFL001 certification holdout is gone — adaptive p-adic lifting
# in exact/dixon.py certifies it in ~440 s; see netlib_extra_r4.)
EXTRA_UNCERTIFIED: set = set()


@pytest.mark.parametrize("name", sorted(__import__("tests.netlib_expected", fromlist=["NETLIB_EXTRA"]).NETLIB_EXTRA))
def test_netlib_extra(name):
    from tests.netlib_expected import NETLIB_EXTRA

    if name in EXTRA_OPEN:
        pytest.skip("degenerate-plateau holdout (see ROADMAP.md)")
    if name in EXTRA_SLOW and not RUN_SLOW:
        pytest.skip(f"slow on CPU ({EXTRA_SLOW[name]}); set RELP_TPU_RUN_SLOW=1")
    expected, tol = NETLIB_EXTRA[name]
    result, solution = solve_netlib(
        f"{name}.SIF",
        pad_to=128,
        dtype="float64",
        scan_dtype="float32",
    )
    assert result.status is SolveStatus.FINITE_OPTIMUM, result.status
    assert solution is not None
    # Exact certification is the hard gate for the extras.
    if name not in EXTRA_UNCERTIFIED:
        assert result.stats.certified, name
    if expected is not None:
        value = float(solution.objective_value)
        assert abs(value - expected) < tol, (name, value, expected)
