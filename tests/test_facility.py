"""The seeded capacitated facility location generator, solved end to end
against scipy's HiGHS."""

import numpy as np
import pytest

from relp_tpu.config import SolverConfig
from relp_tpu.data import facility
from relp_tpu.simplex import SolveStatus, solve_general_form


def test_generator_is_seeded():
    a = facility.generate(7, 5, seed=11)
    b = facility.generate(7, 5, seed=11)
    c = facility.generate(7, 5, seed=12)
    assert facility.to_mps(a) == facility.to_mps(b)
    assert facility.to_mps(a) != facility.to_mps(c)
    assert a.trans_costs.shape == (7, 5)
    # Integer data; capacity ratio 5 up to the integer cut.
    assert a.capacities.sum() <= 5 * a.demands.sum()
    assert a.capacities.sum() >= 5 * a.demands.sum() - a.n_facilities


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_small_instance_matches_highs(seed):
    inst = facility.generate(6, 5, seed=seed)
    gf = facility.general_form(inst)
    result, solution = solve_general_form(gf, SolverConfig(pad_to=8))
    assert result.status is SolveStatus.FINITE_OPTIMUM
    assert result.stats.certified
    highs = facility.highs_objective(inst)
    assert abs(float(solution.objective_value) - highs) <= 1e-6 * abs(highs)


def test_demand_scenario_moves_only_rhs():
    base = facility.generate(4, 3, seed=0)
    scen = facility.with_demand_scale(base, np.array([80, 100, 120, 95]))
    c0, A0, b0, _ = facility.linprog_data(base)
    c1, A1, b1, _ = facility.linprog_data(scen)
    assert np.array_equal(c0, c1)
    assert (A0 != A1).nnz == 0
    assert np.allclose(b1[:4], [-0.8, -1.0, -1.2, -0.95])
    assert "RHS D0 0.80" in facility.to_mps(scen)
