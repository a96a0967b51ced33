"""Burkardt / unicamp / cook / miplib integration suites.

Mirror of the reference's tests/{burkardt,unicamp,cook,miplib}: same problem
files (read from the reference mount), same expected values — many of them
*exact rational equality* assertions, which exercise the full exactness
contract of this framework end to end.
"""

from fractions import Fraction

import pytest

from tests.conftest import reference_problem
from relp_tpu.config import SolverConfig
from relp_tpu.data.elements import LinearProgramError, LPStatus
from relp_tpu.data.solution import Solution
from relp_tpu.io import load_general_form
from relp_tpu.simplex import SolveStatus, solve_general_form

F = Fraction


def solve_suite(suite: str, name: str, **overrides):
    path = reference_problem(suite, name)
    gf = load_general_form(path)
    defaults = dict(pad_to=32, chunk_size=100, refactor_period=100)
    defaults.update(overrides)
    return solve_general_form(gf, SolverConfig(**defaults))


# --- burkardt (reference: tests/burkardt/test.rs) ---


def test_burkardt_adlittle():
    result, solution = solve_suite("burkardt", "adlittle.mps")
    assert result.status is SolveStatus.FINITE_OPTIMUM
    # Exact optimum as asserted by the reference (RationalBig from_str).
    assert solution.objective_value == F(
        24975305659811992079614961229, 120651674036153428931840
    )


def test_burkardt_afiro():
    result, solution = solve_suite("burkardt", "afiro.mps")
    assert result.status is SolveStatus.FINITE_OPTIMUM
    expected = Solution(
        F(-406659, 875),
        [
            ("X01", F(80)),
            ("X02", F(51, 2)),
            ("X03", F(109, 2)),
            ("X04", F(424, 5)),
            ("X06", F(255, 14)),
            ("X07", F(0)),
            ("X08", F(0)),
            ("X09", F(0)),
            ("X10", F(0)),
            ("X11", F(0)),
            ("X12", F(0)),
            ("X13", F(0)),
            ("X14", F(255, 14)),
            ("X15", F(0)),
            ("X16", F(999)),
            ("X22", F(500)),
            ("X23", F(11898, 25)),
            ("X24", F(602, 25)),
            ("X25", F(0)),
            ("X26", F(215)),
            ("X28", F(0)),
            ("X29", F(0)),
            ("X30", F(0)),
            ("X31", F(0)),
            ("X32", F(0)),
            ("X33", F(0)),
            ("X34", F(0)),
            ("X35", F(0)),
            ("X36", F(11898, 35)),
            ("X37", F(11898, 35)),
            ("X38", F(0)),
            ("X39", F(0)),
        ],
    )
    assert expected.is_probably_equal_to(solution, 0.1)


@pytest.mark.skip(
    reason="Reference-ignored: duplicate equal range values for a row "
    "(empstest) are rejected by the shared consistency check."
)
def test_burkardt_empstest():
    solve_suite("burkardt", "empstest.mps")


def test_burkardt_maros():
    result, solution = solve_suite("burkardt", "maros.mps")
    assert result.status is SolveStatus.FINITE_OPTIMUM
    assert solution == Solution(
        F(385, 3),
        [
            ("VOL1", F(10, 3)),
            ("VOL2", F(40, 3)),
            ("VOL3", F(20)),
            ("VOL4", F(0)),
        ],
    )


def test_burkardt_nazareth():
    result, solution = solve_suite("burkardt", "nazareth.mps")
    assert result.status is SolveStatus.UNBOUNDED


def test_burkardt_testprob():
    result, solution = solve_suite("burkardt", "testprob.mps")
    assert result.status is SolveStatus.FINITE_OPTIMUM
    assert solution == Solution(
        F(54),
        [("X1", F(4)), ("X2", F(-1)), ("X3", F(6))],
    )


# --- cook (reference: tests/cook/test.rs) ---


def test_cook_small_example():
    result, solution = solve_suite("cook", "small_example.mps")
    assert result.status is SolveStatus.FINITE_OPTIMUM
    assert abs(float(solution.objective_value) - (-143 / 2)) < 1e-5


# --- unicamp (reference: tests/unicamp/test.rs) ---


def _unicamp(name):
    return solve_suite("unicamp", name)


def test_unicamp_model_data_1():
    result, solution = _unicamp("model_data_1.mps")
    expected = Solution(
        F(123, 38),
        [
            ("COL01", F(5, 2)),
            ("COL02", F(0)),
            ("COL03", F(0)),
            ("COL04", F(9, 14)),
            ("COL05", F(1, 2)),
            ("COL06", F(4)),
            ("COL07", F(0)),
            ("COL08", F(5, 19)),
        ],
    )
    assert solution.is_probably_equal_to(expected, 0.5)


def test_unicamp_model_data_3_1():
    result, solution = _unicamp("model_data_3_1.mps")
    assert solution == Solution(
        F(70),
        [("SUP1", F(200, 3)), ("SUP2", F(100, 3)), ("SUP3", F(100))],
    )


def test_unicamp_model_data_3_2():
    result, solution = _unicamp("model_data_3_2.mps")
    assert solution == Solution(F(180), [("SUP1", F(25)), ("SUP2", F(75))])


def test_unicamp_model_data_3_3():
    result, solution = _unicamp("model_data_3_3.mps")
    assert solution == Solution(F(245), [("SUP1", F(100)), ("SUP2", F(150))])


def test_unicamp_model_data_3_4():
    result, solution = _unicamp("model_data_3_4.mps")
    assert solution.objective_value == F(2250)


def test_unicamp_model_data_4():
    result, solution = _unicamp("model_data_4.mps")
    assert solution == Solution(
        F(7), [("COL01", F(1)), ("COL02", F(2)), ("COL03", F(2))]
    )


def test_unicamp_model_data_6():
    result, solution = _unicamp("model_data_6.mps")
    assert solution.objective_value == F(28)


def test_unicamp_model_data_2_beyond_reference():
    """The reference ignores this problem ("at least one RHS is needed",
    unicamp/test.rs:27): the file has no RHS section.  This framework
    defaults absent right-hand sides to zero and solves it; values match
    the reference's recorded GLPK expectation exactly."""
    result, solution = _unicamp("model_data_2.mps")
    assert solution.objective_value == F(0)
    assert solution.solution_values == [("DCOL1", F(0))]
    assert result.stats.certified


def test_unicamp_model_data_9_beyond_reference():
    """The reference ignores this problem ("Unnamed problem files are not
    supported", unicamp/test.rs:155): the NAME field is empty.  This
    framework accepts unnamed programs; the solution matches the
    reference's recorded GLPK expectation exactly (and is certified,
    where GLPK's was float)."""
    result, solution = _unicamp("model_data_9.mps")
    assert solution.objective_value == F(-100)
    assert solution.solution_values == [
        ("C0000001", F(0)),
        ("C0000002", F(1)),
        ("C0000003", F(1)),
        ("C0000004", F(0)),
    ]
    assert result.stats.certified


# --- miplib root relaxations (reference: tests/miplib/test.rs) ---


def test_miplib_50v():
    result, solution = solve_suite(
        "miplib", "50v-10.mps", pad_to=128
    )
    assert result.status is SolveStatus.FINITE_OPTIMUM
    assert abs(float(solution.objective_value) - 2879.065687) < 1e-3


@pytest.mark.skipif(
    not __import__("os").environ.get("RELP_TPU_RUN_SLOW"),
    reason="~21 min (solved + exactly certified on an accelerator: objective 0, "
    "41 simplex iterations; the reference ignores this problem as too "
    "computationally expensive). Set RELP_TPU_RUN_SLOW=1 to run.",
)
def test_miplib_acc_tight4():
    result, solution = solve_suite("miplib", "acc-tight4.mps", pad_to=128)
    assert result.status is SolveStatus.FINITE_OPTIMUM
    assert abs(float(solution.objective_value) - 0.0) < 1e-3
    assert result.stats.certified


@pytest.mark.skipif(
    not __import__("os").environ.get("RELP_TPU_RUN_SLOW"),
    reason="~8-12 min on CPU. Exact B&B interval on miplib 50v-10 "
    "(the reference stops at the LP root). Set RELP_TPU_RUN_SLOW=1.",
)
def test_miplib_50v_branch_and_bound_interval():
    """Beyond reference scope: on 50v-10 the dive lands an exact certified
    integer incumbent and the tree proves a rigorous rational interval
    around the true optimum 3311.18 (GMI root bound > bare LP bound)."""
    from fractions import Fraction as F_

    from relp_tpu.config import SolverConfig
    from relp_tpu.io import load_general_form
    from relp_tpu.mip import solve_mip

    gf = load_general_form(
        reference_problem("miplib", "50v-10.mps")
    )
    res = solve_mip(
        gf,
        SolverConfig(pad_to=128),
        batch_width=8,
        node_limit=8,
        gomory_cuts=8,
        cut_rounds=1,
        strong_branching=0,
    )
    assert res.dive_incumbent
    assert res.objective is not None and res.best_bound is not None
    assert res.best_bound_exact
    # Rigorous exact interval must enclose the known optimum.
    assert res.best_bound <= F_(331118, 100) <= res.objective
    # The GMI round tightens the root beyond the bare LP bound.
    assert res.root_objective > F_(2880)
