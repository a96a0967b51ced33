"""Exact branch & bound (relp_tpu.mip) — beyond reference scope.

The reference's README roadmap lists branch & bound as unimplemented and its
miplib tests stop at root relaxations (the reference's tests/miplib/mod.rs);
here integer programs solve to certified rational optimality, with the open
frontier batched through the scenario driver (all nodes share the constraint
matrix; branches are rhs-only changes) and dual-warm-restarted from the root
basis.
"""

import copy
import itertools
from fractions import Fraction

import pytest

from relp_tpu.config import SolverConfig
from relp_tpu.data.elements import (
    Objective,
    RangedConstraintRelation,
    VariableType,
)
from relp_tpu.data.general_form import GeneralForm, Variable
from relp_tpu.linalg.sparse import SparseColumnMatrix
from relp_tpu.mip import solve_mip
from relp_tpu.simplex.result import SolveStatus


def _cfg(**overrides):
    defaults = dict(pad_to=8, chunk_size=50, refactor_period=50)
    defaults.update(overrides)
    return SolverConfig(**defaults)


def _gf(objective, rows, relations, b, costs, bounds, types, names=None):
    return GeneralForm(
        objective=objective,
        constraints=SparseColumnMatrix.from_dense(
            [[Fraction(v) for v in row] for row in rows]
        ),
        constraint_types=relations,
        b=[Fraction(v) for v in b],
        variables=[
            Variable(
                variable_type=t,
                cost=Fraction(c),
                lower_bound=None if lo is None else Fraction(lo),
                upper_bound=None if hi is None else Fraction(hi),
            )
            for c, (lo, hi), t in zip(costs, bounds, types)
        ],
        variable_names=names or [f"x{j}" for j in range(len(costs))],
    )


def test_mip_branches_to_integer_optimum():
    """max 5x+4y s.t. 6x+4y<=24, x+2y<=6, x in [0,4], y in [0,3] integers.
    LP relaxation: (3, 3/2) with value 21; MIP optimum: (4, 0) value 20."""
    gf = _gf(
        Objective.MAXIMIZE,
        [[6, 4], [1, 2]],
        [RangedConstraintRelation.less(), RangedConstraintRelation.less()],
        [24, 6],
        [5, 4],
        [(0, 4), (0, 3)],
        [VariableType.INTEGER, VariableType.INTEGER],
        names=["x", "y"],
    )
    res = solve_mip(gf, _cfg())
    assert res.status is SolveStatus.FINITE_OPTIMUM
    assert res.certified
    # Standardized minimize sense: max 5x+4y == min -(5x+4y).
    assert res.objective == Fraction(-20)
    # Root bound: -21 for the bare relaxation, tightened toward -20 by the
    # root GMI cuts (exactly -62/3 with the default cut round).
    assert Fraction(-21) <= res.root_objective <= Fraction(-20)
    assert res.solution.value_of("x") == 4
    assert res.solution.value_of("y") == 0
    assert res.nodes_solved > 1


def test_mip_gomory_cuts_tighten_root_and_prune():
    """The same MIP with and without root GMI cuts: identical exact optimum,
    strictly tighter root bound, no more nodes than the cut-free tree."""
    def build():
        return _gf(
            Objective.MAXIMIZE,
            [[6, 4], [1, 2]],
            [RangedConstraintRelation.less(), RangedConstraintRelation.less()],
            [24, 6],
            [5, 4],
            [(0, 4), (0, 3)],
            [VariableType.INTEGER, VariableType.INTEGER],
        )

    with_cuts = solve_mip(build(), _cfg(), gomory_cuts=8)
    without = solve_mip(build(), _cfg(), gomory_cuts=0)
    assert with_cuts.objective == without.objective == Fraction(-20)
    assert without.root_objective == Fraction(-21)
    assert with_cuts.root_objective > without.root_objective
    assert with_cuts.nodes_solved <= without.nodes_solved
    assert with_cuts.certified and without.certified


def _integral_root_gf():
    return _gf(
        Objective.MAXIMIZE,
        [[1, 1]],
        [RangedConstraintRelation.less()],
        [4],
        [1, 1],
        [(0, 2), (0, 2)],
        [VariableType.INTEGER, VariableType.INTEGER],
    )


def test_mip_presolve_solves_forced_constraint_outright():
    """max x+y, x+y<=4, x,y in [0,2]: the upper activity bound meets the rhs,
    so MIP-safe presolve removes the row and fixes both variables at their
    (integral) upper bounds — zero B&B nodes, exact answer, minimize-sense
    objective."""
    res = solve_mip(_integral_root_gf(), _cfg())
    assert res.status is SolveStatus.FINITE_OPTIMUM
    assert res.objective == Fraction(-4)
    assert res.nodes_solved == 0
    assert res.certified
    assert res.solution.value_of("x0") == 2
    assert res.solution.value_of("x1") == 2


def test_mip_integral_root_needs_no_branching():
    """Same model with presolve off: the root relaxation lands integral and
    B&B stops after the single root node."""
    res = solve_mip(_integral_root_gf(), _cfg(presolve=False))
    assert res.status is SolveStatus.FINITE_OPTIMUM
    assert res.objective == Fraction(-4)
    assert res.nodes_solved == 1
    assert res.certified


def test_mip_integer_infeasible_window():
    """x integer with 1/5 <= x <= 4/5: LP feasible, no integer point."""
    gf = _gf(
        Objective.MINIMIZE,
        [[1]],
        [RangedConstraintRelation.less()],
        [1],
        [1],
        [(Fraction(1, 5), Fraction(4, 5))],
        [VariableType.INTEGER],
    )
    res = solve_mip(gf, _cfg())
    assert res.status is SolveStatus.INFEASIBLE


def test_mip_mixed_integer_continuous():
    """min -(x+y), x continuous in [0, 3/2], y integer in [0,10], x+y<=27/10.
    LP: (3/2, 6/5); MIP optimum: y=2, x=7/10 -> -27/10."""
    gf = _gf(
        Objective.MINIMIZE,
        [[1, 1]],
        [RangedConstraintRelation.less()],
        [Fraction(27, 10)],
        [-1, -1],
        [(0, Fraction(3, 2)), (0, 10)],
        [VariableType.CONTINUOUS, VariableType.INTEGER],
        names=["x", "y"],
    )
    res = solve_mip(gf, _cfg())
    assert res.status is SolveStatus.FINITE_OPTIMUM
    assert res.certified
    assert res.objective == Fraction(-27, 10)
    assert res.solution.value_of("y") == 2
    assert res.solution.value_of("x") == Fraction(7, 10)


def test_mip_knapsack_matches_brute_force():
    """6-item 0/1 knapsack solved through batched waves (batch_width=4);
    optimum cross-checked by exact enumeration."""
    values = [10, 13, 7, 8, 12, 9]
    weights = [5, 7, 4, 3, 6, 5]
    W = 14
    best = max(
        (
            sum(v for v, take in zip(values, picks) if take)
            for picks in itertools.product([0, 1], repeat=6)
            if sum(w for w, take in zip(weights, picks) if take) <= W
        ),
    )
    gf = _gf(
        Objective.MAXIMIZE,
        [weights],
        [RangedConstraintRelation.less()],
        [W],
        values,
        [(0, 1)] * 6,
        [VariableType.INTEGER] * 6,
    )
    res = solve_mip(gf, _cfg(), batch_width=4)
    assert res.status is SolveStatus.FINITE_OPTIMUM
    assert res.certified
    assert res.objective == -best
    # The incumbent solution is integer feasible in the original space.
    picked = [res.solution.value_of(f"x{j}") for j in range(6)]
    assert all(v in (0, 1) for v in picked)
    assert sum(w * v for w, v in zip(weights, picked)) <= W
    assert sum(v * p for v, p in zip(values, picked)) == best


def test_mip_general_integers_match_brute_force():
    """10 general-integer variables (0..2), 3 knapsack rows: the certified
    B&B optimum equals exhaustive enumeration (3^10 points), and the lazy
    branch-row mechanism materializes rows for only a few variables."""
    rng_c = [7, 2, 9, 4, 8, 3, 6, 5, 1, 10]
    rows = [
        [3, 1, 4, 1, 5, 2, 6, 2, 1, 3],
        [1, 2, 2, 3, 1, 4, 1, 2, 3, 2],
        [2, 3, 1, 2, 2, 1, 3, 1, 2, 4],
    ]
    caps = [17, 11, 13]
    best = max(
        sum(c * x for c, x in zip(rng_c, point))
        for point in itertools.product([0, 1, 2], repeat=10)
        if all(
            sum(a * x for a, x in zip(row, point)) <= cap
            for row, cap in zip(rows, caps)
        )
    )
    gf = _gf(
        Objective.MAXIMIZE,
        rows,
        [RangedConstraintRelation.less()] * 3,
        caps,
        rng_c,
        [(0, 2)] * 10,
        [VariableType.INTEGER] * 10,
    )
    res = solve_mip(gf, _cfg(), batch_width=8)
    assert res.status is SolveStatus.FINITE_OPTIMUM
    assert res.certified
    assert res.objective == -best
    point = [res.solution.value_of(f"x{j}") for j in range(10)]
    assert all(v in (0, 1, 2) for v in point)
    assert all(
        sum(a * x for a, x in zip(row, point)) <= cap
        for row, cap in zip(rows, caps)
    )
    # Cut-free run: forces real branching; lazy rows materialize for far
    # fewer variables than the 10 integers, and the optimum agrees.
    res0 = solve_mip(
        _gf(
            Objective.MAXIMIZE,
            rows,
            [RangedConstraintRelation.less()] * 3,
            caps,
            rng_c,
            [(0, 2)] * 10,
            [VariableType.INTEGER] * 10,
        ),
        _cfg(),
        batch_width=8,
        gomory_cuts=0,
    )
    assert res0.certified and res0.objective == -best
    assert res0.nodes_solved > 1
    assert 0 < res0.branch_vars_used < 10


def test_mip_presolve_rounds_derived_bounds_to_infeasibility():
    """Singleton RANGE row 5 <= 10x <= 8 gives x in [1/2, 4/5]; MIP-safe
    rounding (ceil/floor) empties the integer window during presolve. The
    LP relaxation is feasible, so only the rounding can conclude this."""
    gf = _gf(
        Objective.MINIMIZE,
        [[10, 0], [0, 1]],
        [RangedConstraintRelation.ranged(3), RangedConstraintRelation.less()],
        [8, 9],
        [1, 1],
        [(0, 3), (0, 9)],
        [VariableType.INTEGER, VariableType.CONTINUOUS],
    )
    # Row 0 touches only x0 (the x1 coefficient is 0 and dropped by the
    # sparse builder), so the singleton rule fires on it.
    res = solve_mip(gf, _cfg())
    assert res.status is SolveStatus.INFEASIBLE


def test_mip_presolve_keeps_integer_slack_column():
    """min -y, x + 2y = 3, x integer in [0,3] with cost 0, y in [0, 7/5].
    LP slack elimination would remove x as (3 - 2y) and report y = 7/5 with
    x = 1/5 — fractional.  The MIP-safe gate keeps the integer column and
    B&B lands on x = 1, y = 1."""
    gf = _gf(
        Objective.MINIMIZE,
        [[1, 2]],
        [RangedConstraintRelation.equal()],
        [3],
        [0, -1],
        [(0, 3), (0, Fraction(7, 5))],
        [VariableType.INTEGER, VariableType.CONTINUOUS],
        names=["x", "y"],
    )
    res = solve_mip(gf, _cfg())
    assert res.status is SolveStatus.FINITE_OPTIMUM
    assert res.certified
    assert res.objective == Fraction(-1)
    assert res.solution.value_of("x") == 1
    assert res.solution.value_of("y") == 1


def test_mip_objective_includes_shift_fixed_cost():
    """Nonzero integer lower bounds shift into fixed_cost at standardization;
    the reported minimize-sense objective must include it.  min x + y,
    x + y >= 7/2, x, y integer in [2, 5] -> optimum 4 (LP bound 4 too after
    activity rounding -- force B&B off presolve with a second row)."""
    gf = _gf(
        Objective.MINIMIZE,
        [[1, 1], [1, -1]],
        [RangedConstraintRelation.greater(), RangedConstraintRelation.less()],
        [Fraction(7, 2), 3],
        [1, 1],
        [(2, 5), (2, 5)],
        [VariableType.INTEGER, VariableType.INTEGER],
        names=["x", "y"],
    )
    res = solve_mip(gf, _cfg())
    assert res.status is SolveStatus.FINITE_OPTIMUM
    assert res.certified
    assert res.objective == Fraction(4)
    assert res.solution.value_of("x") + res.solution.value_of("y") == 4


def test_mip_presolve_closes_singleton_unbounded_integer():
    """min x, x >= 1, x integer with no upper bound: the MIP-safe presolve
    removes the singleton row and optimizes the then-independent column at
    its (integral) lower bound — no B&B, no finite-upper-bound requirement."""
    gf = _gf(
        Objective.MINIMIZE,
        [[1]],
        [RangedConstraintRelation.greater()],
        [1],
        [1],
        [(0, None)],
        [VariableType.INTEGER],
    )
    res = solve_mip(gf, _cfg())
    assert res.status is SolveStatus.FINITE_OPTIMUM
    assert res.objective == Fraction(1)
    assert res.nodes_solved == 0  # solved entirely in presolve
    assert res.solution.value_of("x0") == 1


def test_mip_rejects_unbounded_integer():
    """An upper-unbounded integer that *survives* presolve (two rows keep it
    from the singleton rule) still fails fast with a clear error."""
    gf = _gf(
        Objective.MINIMIZE,
        [[1, 1], [1, -1]],
        [RangedConstraintRelation.greater(), RangedConstraintRelation.less()],
        [1, 5],
        [1, 1],
        [(0, None), (0, 9)],
        [VariableType.INTEGER, VariableType.INTEGER],
    )
    with pytest.raises(NotImplementedError):
        solve_mip(gf, _cfg())


def test_mip_multi_round_cuts_tighten_monotonically():
    """More root GMI rounds can only tighten (never loosen) the exact root
    bound, and the certified optimum is invariant."""
    def build():
        return _gf(
            Objective.MAXIMIZE,
            [[6, 4], [1, 2]],
            [RangedConstraintRelation.less(), RangedConstraintRelation.less()],
            [24, 6],
            [5, 4],
            [(0, 4), (0, 3)],
            [VariableType.INTEGER, VariableType.INTEGER],
        )

    one = solve_mip(build(), _cfg(), cut_rounds=1)
    many = solve_mip(build(), _cfg(), cut_rounds=4)
    assert one.objective == many.objective == Fraction(-20)
    assert one.certified and many.certified
    assert many.root_objective >= one.root_objective
    assert many.root_objective > Fraction(-21)  # beats the bare relaxation


def test_mip_branching_rules_agree_on_optimum():
    """Pseudocost and most-fractional branching explore different trees but
    certify the same exact optimum (cut-free run forces real branching)."""
    def build():
        rows = [
            [3, 1, 4, 1, 5, 2, 6, 2, 1, 3],
            [1, 2, 2, 3, 1, 4, 1, 2, 3, 2],
            [2, 3, 1, 2, 2, 1, 3, 1, 2, 4],
        ]
        return _gf(
            Objective.MAXIMIZE,
            rows,
            [RangedConstraintRelation.less()] * 3,
            [17, 11, 13],
            [7, 2, 9, 4, 8, 3, 6, 5, 1, 10],
            [(0, 2)] * 10,
            [VariableType.INTEGER] * 10,
        )

    ps = solve_mip(build(), _cfg(), gomory_cuts=0, branching="pseudocost")
    mf = solve_mip(build(), _cfg(), gomory_cuts=0, branching="most_fractional")
    assert ps.certified and mf.certified
    assert ps.objective == mf.objective
    assert ps.nodes_solved > 1 and mf.nodes_solved > 1


def test_mip_unknown_branching_rejected():
    gf = _integral_root_gf()
    with pytest.raises(ValueError):
        solve_mip(gf, _cfg(), branching="strong")


def test_mip_best_bound_and_gap_on_completion():
    """A finished tree reports best_bound == objective and an exact 0 gap."""
    gf = _gf(
        Objective.MAXIMIZE,
        [[6, 4], [1, 2]],
        [RangedConstraintRelation.less(), RangedConstraintRelation.less()],
        [24, 6],
        [5, 4],
        [(0, 4), (0, 3)],
        [VariableType.INTEGER, VariableType.INTEGER],
    )
    res = solve_mip(gf, _cfg())
    assert res.best_bound == res.objective == Fraction(-20)
    assert res.best_bound_exact
    assert res.gap == 0


def test_mip_rel_gap_stops_early_with_rigorous_interval():
    """rel_gap=1/2: branch & bound stops as soon as the exact interval
    [best_bound, incumbent] is proven within 50%, uncertified but with an
    exact bound pair enclosing the true optimum (-20)."""
    gf = _gf(
        Objective.MAXIMIZE,
        [[6, 4], [1, 2]],
        [RangedConstraintRelation.less(), RangedConstraintRelation.less()],
        [24, 6],
        [5, 4],
        [(0, 4), (0, 3)],
        [VariableType.INTEGER, VariableType.INTEGER],
    )
    res = solve_mip(gf, _cfg(), gomory_cuts=0, rel_gap=Fraction(1, 2))
    assert res.status is SolveStatus.FINITE_OPTIMUM
    assert res.objective is not None and res.best_bound is not None
    assert res.best_bound <= Fraction(-20) <= res.objective
    assert res.gap is not None and res.gap <= Fraction(1, 2)
    if res.gap > 0:
        assert not res.certified  # early stop: optimality not proven
        assert res.best_bound_exact


def test_mip_time_limit_zero_stops_before_first_wave():
    gf = _gf(
        Objective.MAXIMIZE,
        [[6, 4], [1, 2]],
        [RangedConstraintRelation.less(), RangedConstraintRelation.less()],
        [24, 6],
        [5, 4],
        [(0, 4), (0, 3)],
        [VariableType.INTEGER, VariableType.INTEGER],
    )
    res = solve_mip(gf, _cfg(), gomory_cuts=0, time_limit_s=0.0)
    assert res.time_limit_hit
    assert res.nodes_solved == 1  # only the root was solved
    assert not res.certified
    # The root bound is still a rigorous global bound.
    assert res.best_bound is not None and res.best_bound <= Fraction(-20)


def test_mip_strong_branching_fixes_infeasible_side():
    """min 10x + y, 2x + y >= 4, y in [0,1], x integer in [0,3]: root LP is
    (3/2, 1).  The down child (x <= 1) forces y >= 2 > 1 — certified exact
    Farkas infeasibility — so root strong branching fixes x >= 2 before any
    branching.  Presolve is off so the fixing can only come from strong
    branching; the optimum (x=2, y=0, objective 20) must be certified both
    with and without it."""
    def build():
        return _gf(
            Objective.MINIMIZE,
            [[2, 1]],
            [RangedConstraintRelation.greater()],
            [4],
            [10, 1],
            [(0, 3), (0, 1)],
            [VariableType.INTEGER, VariableType.CONTINUOUS],
            names=["x", "y"],
        )

    sb = solve_mip(
        build(), _cfg(presolve=False), gomory_cuts=0, strong_branching=8
    )
    plain = solve_mip(
        build(), _cfg(presolve=False), gomory_cuts=0, strong_branching=0
    )
    assert sb.status is plain.status is SolveStatus.FINITE_OPTIMUM
    assert sb.objective == plain.objective == Fraction(20)
    assert sb.certified and plain.certified
    assert sb.solution.value_of("x") == 2
    # The fixed side never becomes an LP node.
    assert sb.nodes_solved <= plain.nodes_solved


def test_mip_netlib_scale_boeing2_mixed_integer():
    """Netlib-scale mixed-integer B&B: BOEING2 with its 12 doubly-bounded
    structural variables restricted to integers.  The certified exact
    rational optimum is pinned (branching order cannot change it), the
    root relaxation bounds it from below, and every restricted variable
    lands integral."""
    from conftest import reference_problem
    from relp_tpu.io import load_general_form

    gf = load_general_form(reference_problem("netlib", "BOEING2.SIF"))
    names = []
    for (name, _), v in zip(gf.original_variables, gf.variables):
        lo, hi = v.lower_bound, v.upper_bound
        if (
            lo is not None
            and hi is not None
            and hi > lo
            and hi - lo <= 100
            and len(names) < 12
        ):
            v.variable_type = VariableType.INTEGER
            names.append(name)
    assert len(names) == 12

    res = solve_mip(
        gf, SolverConfig(pad_to=128), batch_width=8, node_limit=64
    )
    assert res.status is SolveStatus.FINITE_OPTIMUM
    assert res.certified
    assert res.gap == 0
    assert res.objective == Fraction(
        -81445292308040766845970441451482629,
        260018738544462172183354887000000,
    )
    assert res.root_objective <= res.objective
    for name in names:
        assert res.solution.value_of(name).denominator == 1


def test_mip_rounding_dive_installs_root_incumbent():
    """min x1 + 1.01 x2, 2x1 + 2x2 >= 7, x integer in [0,3]: the LP root is
    fractional; the dive fixes x2 -> 1 (nearest), re-solves to x1 = 5/2,
    fixes x1 -> 3, and lands the exact optimum (3, 1) as the incumbent
    before any branching (cuts and strong branching disabled to force the
    dive path)."""
    gf = _gf(
        Objective.MINIMIZE,
        [[2, 2]],
        [RangedConstraintRelation.greater()],
        [7],
        [1, Fraction(101, 100)],
        [(0, 3), (0, 3)],
        [VariableType.INTEGER, VariableType.INTEGER],
        names=["x1", "x2"],
    )
    res = solve_mip(
        gf, _cfg(presolve=False), gomory_cuts=0, strong_branching=0
    )
    assert res.status is SolveStatus.FINITE_OPTIMUM
    assert res.certified
    assert res.objective == Fraction(401, 100)
    assert res.dive_lps >= 1
    assert res.dive_incumbent
    assert res.solution.value_of("x1") == 3
    assert res.solution.value_of("x2") == 1


def test_mip_branch_and_bound_over_mesh():
    """Exact B&B with node waves sharded over a 2x4 (batch x col) CPU mesh:
    identical certified rational optimum to the single-device run — the
    mesh only changes WHERE the batched scenario chunks execute."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    from relp_tpu.parallel.mesh import make_mesh

    def build():
        rows = [
            [3, 1, 4, 1, 5, 2, 6, 2, 1, 3],
            [1, 2, 2, 3, 1, 4, 1, 2, 3, 2],
            [2, 3, 1, 2, 2, 1, 3, 1, 2, 4],
        ]
        return _gf(
            Objective.MAXIMIZE,
            rows,
            [RangedConstraintRelation.less()] * 3,
            [17, 11, 13],
            [7, 2, 9, 4, 8, 3, 6, 5, 1, 10],
            [(0, 2)] * 10,
            [VariableType.INTEGER] * 10,
        )

    mesh = make_mesh((2, 4))
    meshed = solve_mip(
        build(), _cfg(), batch_width=8, gomory_cuts=0, mesh=mesh
    )
    plain = solve_mip(build(), _cfg(), batch_width=8, gomory_cuts=0)
    assert meshed.status is plain.status is SolveStatus.FINITE_OPTIMUM
    assert meshed.certified and plain.certified
    assert meshed.objective == plain.objective


def test_mip_cover_cuts_close_knapsack_root():
    """max 10(x1+x2+x3), 5x1+5x2+5x3 <= 12, x binary: LP root (0.8,0.8,0.8)
    = 24; the minimal cover {1,2,3} gives x1+x2+x3 <= 2, closing the root
    bound to the exact optimum 20 with GMI disabled."""
    def build():
        return _gf(
            Objective.MAXIMIZE,
            [[5, 5, 5]],
            [RangedConstraintRelation.less()],
            [12],
            [10, 10, 10],
            [(0, 1)] * 3,
            [VariableType.INTEGER] * 3,
        )

    covered = solve_mip(
        build(), _cfg(presolve=False), gomory_cuts=0, cover_cuts=8,
        strong_branching=0,
    )
    bare = solve_mip(
        build(), _cfg(presolve=False), gomory_cuts=0, cover_cuts=0,
        strong_branching=0,
    )
    assert covered.objective == bare.objective == Fraction(-20)
    assert covered.certified and bare.certified
    assert bare.root_objective == Fraction(-24)
    assert covered.root_objective == Fraction(-20)  # cover closes the root


def test_mip_rins_preserves_verdicts_and_can_improve():
    """RINS (rins_rounds>0) never changes the certified verdict, and with a
    crippled tree (node_limit=1, no dive pruning budget) the RINS sub-MIP
    still recovers the true optimum as a certified incumbent."""
    values = [10, 13, 7, 8, 12, 9]
    weights = [5, 7, 4, 3, 6, 5]
    W = 14
    gf = _gf(
        Objective.MAXIMIZE,
        [weights],
        [RangedConstraintRelation.less()],
        [W],
        values,
        [(0, 1)] * 6,
        [VariableType.INTEGER] * 6,
    )
    base = solve_mip(copy.deepcopy(gf), _cfg(), batch_width=4)
    with_rins = solve_mip(
        copy.deepcopy(gf), _cfg(), batch_width=4, rins_rounds=2
    )
    assert with_rins.status is SolveStatus.FINITE_OPTIMUM
    assert with_rins.certified
    assert with_rins.objective == base.objective

    # Crippled tree: the incumbent must come from dive+RINS alone, and the
    # reported interval stays rigorous.
    crippled = solve_mip(
        copy.deepcopy(gf),
        _cfg(),
        batch_width=1,
        node_limit=1,
        rins_rounds=2,
        rins_nodes=100,
    )
    assert crippled.status is SolveStatus.FINITE_OPTIMUM
    assert crippled.objective >= base.objective
    if crippled.rins_incumbent:
        sol = crippled.solution
        picked = [sol.value_of(f"x{j}") for j in range(6)]
        assert all(v in (0, 1) for v in picked)
        assert sum(w * v for w, v in zip(weights, picked)) <= W


def test_mip_local_branching_improves_incumbent():
    """Local branching: with a crippled tree (node_limit=1), a Hamming ball
    around the dive incumbent recovers the true knapsack optimum — flips
    can OPEN binaries that are 0 in both the LP and the incumbent, which
    RINS-style agreement fixing cannot."""
    values = [10, 13, 7, 8, 12, 9]
    weights = [5, 7, 4, 3, 6, 5]
    W = 14
    best = max(
        sum(v for v, take in zip(values, picks) if take)
        for picks in itertools.product([0, 1], repeat=6)
        if sum(w for w, take in zip(weights, picks) if take) <= W
    )
    gf = _gf(
        Objective.MAXIMIZE,
        [weights],
        [RangedConstraintRelation.less()],
        [W],
        values,
        [(0, 1)] * 6,
        [VariableType.INTEGER] * 6,
    )
    res = solve_mip(
        copy.deepcopy(gf),
        _cfg(),
        batch_width=1,
        node_limit=1,
        local_branching=6,  # radius covers the whole cube
        lb_rounds=2,
        rins_nodes=200,
    )
    assert res.status is SolveStatus.FINITE_OPTIMUM
    assert res.objective == -best
    picked = [res.solution.value_of(f"x{j}") for j in range(6)]
    assert sum(w * v for w, v in zip(weights, picked)) <= W


def test_mip_hint_only_incumbent_with_rins_and_lb():
    """Public-API combo: incumbent_hint supplied, dive disabled, and a tree
    too small to find its own incumbent — RINS and local branching must fall
    back to the hint Solution instead of dereferencing a None provider
    (advisor r3, branch_bound.py _incumbent_orig_values/_current_solution)."""
    values = [10, 13, 7, 8, 12, 9]
    weights = [5, 7, 4, 3, 6, 5]
    W = 14
    gf = _gf(
        Objective.MAXIMIZE,
        [weights],
        [RangedConstraintRelation.less()],
        [W],
        values,
        [(0, 1)] * 6,
        [VariableType.INTEGER] * 6,
    )
    base = solve_mip(copy.deepcopy(gf), _cfg(), batch_width=4)
    assert base.solution is not None
    res = solve_mip(
        copy.deepcopy(gf),
        _cfg(),
        batch_width=1,
        node_limit=1,
        dive_rounds=0,
        incumbent_hint=base.solution,
        rins_rounds=1,
        local_branching=6,
        lb_rounds=1,
        rins_nodes=100,
    )
    assert res.status is SolveStatus.FINITE_OPTIMUM
    # The hint is the true optimum; neighborhoods may confirm but not beat it.
    assert res.objective == base.objective
