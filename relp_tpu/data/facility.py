"""Seeded capacitated facility location instances.

The problem family is Cornuéjols, Sridharan & Thizy (1991); the generator
follows Gasse et al. (NeurIPS 2019, the Ecole/learn2branch
``generate_capacited_facility_location``), with its published defaults
(100 customers x 100 facilities, capacity ratio 5).  Costs, demands and
capacities are integers, so the LP data is exact as written.

Formulation (LP relaxation; ``integer_y`` keeps ``y`` integral for MIP)::

    min  sum_ij t_ij x_ij + sum_j f_j y_j
    s.t. sum_j x_ij            >= r_i              (demand_i)
         sum_i d_i x_ij - s_j y_j <= 0             (capacity_j)
         sum_j s_j y_j         >= sum_i d_i r_i    (total capacity)
         x_ij - y_j            <= 0                (affectation_ij)
         0 <= x_ij <= 1, 0 <= y_j <= 1

``x_ij`` is the share of customer i's base demand ``d_i`` served by
facility j.  The published instance has ``r = 1``; a demand scenario scales
customer i's demand to ``r_i d_i`` (:func:`with_demand_scale`), which moves
only right-hand sides, so one basis can warm-start every scenario.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class FacilityLocation:
    trans_costs: np.ndarray  # (n_customers, n_facilities) int64
    fixed_costs: np.ndarray  # (n_facilities,) int64
    demands: np.ndarray  # (n_customers,) int64
    capacities: np.ndarray  # (n_facilities,) int64
    # r_i in percent (scenario demand / base demand); None means 100.
    demand_pct: Optional[np.ndarray] = None

    def pct(self) -> np.ndarray:
        if self.demand_pct is None:
            return np.full(self.n_customers, 100, np.int64)
        return np.asarray(self.demand_pct, np.int64)

    @property
    def n_customers(self) -> int:
        return int(self.demands.shape[0])

    @property
    def n_facilities(self) -> int:
        return int(self.capacities.shape[0])


def generate(
    n_customers: int = 100,
    n_facilities: int = 100,
    *,
    seed: int = 0,
    ratio: float = 5.0,
) -> FacilityLocation:
    """One instance, deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    c_x = rng.random(n_customers)
    c_y = rng.random(n_customers)
    f_x = rng.random(n_facilities)
    f_y = rng.random(n_facilities)
    demands = rng.integers(5, 35 + 1, size=n_customers)
    capacities = rng.integers(10, 160 + 1, size=n_facilities)
    fixed_costs = rng.integers(100, 110 + 1, size=n_facilities) * np.sqrt(
        capacities
    ) + rng.integers(90 + 1, size=n_facilities)
    fixed_costs = fixed_costs.astype(np.int64)
    # Scale capacities so that total capacity is ``ratio`` x total demand.
    capacities = (
        capacities * ratio * demands.sum() / capacities.sum()
    ).astype(np.int64)
    dist = np.sqrt(
        (c_x[:, None] - f_x[None, :]) ** 2 + (c_y[:, None] - f_y[None, :]) ** 2
    )
    trans_costs = np.rint(dist * 10 * demands[:, None]).astype(np.int64)
    return FacilityLocation(
        trans_costs=trans_costs,
        fixed_costs=fixed_costs,
        demands=demands.astype(np.int64),
        capacities=capacities,
    )


def with_demand_scale(inst: FacilityLocation, pct: np.ndarray) -> FacilityLocation:
    """A demand scenario: customer i's demand becomes ``pct_i`` percent of
    its base demand (right-hand sides only)."""
    return dataclasses.replace(inst, demand_pct=np.asarray(pct, np.int64))


def _percent(value: int) -> str:
    """Exact decimal text of ``value / 100`` for an integer ``value >= 0``."""
    return f"{value // 100}.{value % 100:02d}"


def to_mps(inst: FacilityLocation, *, integer_y: bool = False) -> str:
    """Free-format MPS text of the instance."""
    nc, nf = inst.n_customers, inst.n_facilities
    lines: List[str] = ["NAME CFL", "ROWS", " N COST"]
    lines += [f" G D{i}" for i in range(nc)]
    lines += [f" L C{j}" for j in range(nf)]
    lines.append(" G TOT")
    lines += [f" L A{i}_{j}" for i in range(nc) for j in range(nf)]
    lines.append("COLUMNS")
    d = inst.demands
    for i in range(nc):
        for j in range(nf):
            x = f"x{i}_{j}"
            lines.append(f" {x} COST {int(inst.trans_costs[i, j])} D{i} 1")
            lines.append(f" {x} C{j} {int(d[i])} A{i}_{j} 1")
    if integer_y:
        lines.append(" M1 'MARKER' 'INTORG'")
    for j in range(nf):
        y = f"y{j}"
        s = int(inst.capacities[j])
        lines.append(f" {y} COST {int(inst.fixed_costs[j])} C{j} {-s}")
        lines.append(f" {y} TOT {s}")
        lines += [f" {y} A{i}_{j} -1" for i in range(nc)]
    if integer_y:
        lines.append(" M2 'MARKER' 'INTEND'")
    lines.append("RHS")
    pct = inst.pct()
    lines += [f" RHS D{i} {_percent(int(pct[i]))}" for i in range(nc)]
    lines.append(f" RHS TOT {_percent(int(d @ pct))}")
    lines.append("BOUNDS")
    lines += [f" UP BND x{i}_{j} 1" for i in range(nc) for j in range(nf)]
    lines += [f" UP BND y{j} 1" for j in range(nf)]
    lines.append("ENDATA")
    return "\n".join(lines) + "\n"


def general_form(inst: FacilityLocation, *, integer_y: bool = False):
    """The instance as a :class:`~relp_tpu.data.general_form.GeneralForm`,
    through the same MPS text a user would write to a file."""
    from relp_tpu.io import mps_to_general_form, parse_free

    return mps_to_general_form(parse_free(to_mps(inst, integer_y=integer_y)))


def linprog_data(inst: FacilityLocation):
    """``(c, A_ub, b_ub, bounds)`` for ``scipy.optimize.linprog``/``milp``
    in the variable order x_00 .. x_{nc-1,nf-1}, y_0 .. y_{nf-1}."""
    import scipy.sparse as sp

    nc, nf = inst.n_customers, inst.n_facilities
    nx = nc * nf
    n = nx + nf
    c = np.concatenate(
        [inst.trans_costs.reshape(-1), inst.fixed_costs]
    ).astype(np.float64)
    rows, cols, vals = [], [], []
    b: List[float] = []
    r = 0
    xi = np.arange(nx).reshape(nc, nf)
    pct = inst.pct()
    for i in range(nc):  # -sum_j x_ij <= -r_i
        rows += [r] * nf
        cols += list(xi[i])
        vals += [-1.0] * nf
        b.append(-pct[i] / 100.0)
        r += 1
    for j in range(nf):  # sum_i d_i x_ij - s_j y_j <= 0
        rows += [r] * (nc + 1)
        cols += list(xi[:, j]) + [nx + j]
        vals += list(inst.demands.astype(float)) + [-float(inst.capacities[j])]
        b.append(0.0)
        r += 1
    rows += [r] * nf  # -sum_j s_j y_j <= -sum_i d_i r_i
    cols += list(range(nx, n))
    vals += list(-inst.capacities.astype(float))
    b.append(-float(inst.demands @ pct) / 100.0)
    r += 1
    for i in range(nc):  # x_ij - y_j <= 0
        for j in range(nf):
            rows += [r, r]
            cols += [int(xi[i, j]), nx + j]
            vals += [1.0, -1.0]
            b.append(0.0)
            r += 1
    A = sp.csr_matrix((vals, (rows, cols)), shape=(r, n))
    return c, A, np.asarray(b), [(0.0, 1.0)] * n


def highs_objective(inst: FacilityLocation) -> Optional[float]:
    """Optimal LP-relaxation objective by scipy's HiGHS (the plain
    reference), or None when HiGHS reports no optimum."""
    from scipy.optimize import linprog

    c, A, b, bounds = linprog_data(inst)
    res = linprog(c, A_ub=A, b_ub=b, bounds=bounds, method="highs")
    return float(res.fun) if res.status == 0 else None
