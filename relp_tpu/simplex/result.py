"""Solver results.

Mirror of the reference's result vocabulary (``OptimizationResult`` in
algorithm/mod.rs:43-47 + the infeasible verdict of phase 1): finite optimum
carrying a basic feasible solution, unbounded, or infeasible — plus solver
statistics new to this framework (iterations, refactorizations, wall time).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

from relp_tpu.linalg.sparse import SparseVector


class SolveStatus(enum.Enum):
    FINITE_OPTIMUM = "finite_optimum"
    INFEASIBLE = "infeasible"
    UNBOUNDED = "unbounded"
    ITERATION_LIMIT = "iteration_limit"
    NUMERICAL_ERROR = "numerical_error"


@dataclass
class SolveStats:
    iterations: int = 0
    phase1_iterations: int = 0
    # Dual-simplex pivots taken restoring a warm basis after a rhs change
    # (0 unless the dual warm-restart path ran).
    dual_iterations: int = 0
    refactorizations: int = 0
    # Refactorizations the device rejected and host LAPACK (f64) redid.
    host_refactors: int = 0
    chunks: int = 0
    exact_cleanup_pivots: int = 0
    certified: bool = False
    wall_time_s: float = 0.0
    # Host-side exact certification/cleanup wall time (subset of
    # wall_time_s); wall_time_s - certify_time_s is device pivots + compile.
    certify_time_s: float = 0.0
    removed_rows: List[int] = field(default_factory=list)
    # True when this LP was part of a batch solve but was routed through the
    # single-LP driver (numerics/certification gate or straggler cap).
    batch_fallback: bool = False
    # Escalation rungs the driver retried with, in order (e.g. "df32",
    # "float64") — no silent precision switches.
    escalations: List[str] = field(default_factory=list)
    # Padded (M, N) of the device tableau of the last rung (None when no
    # device lowering ran).
    device_shape: Optional[Tuple[int, int]] = None


@dataclass
class OptimizationResult:
    status: SolveStatus
    # Float BFS over provider columns (present on FINITE_OPTIMUM).
    bfs: Optional[SparseVector] = None
    # Float objective value of the provider-level LP.
    objective: Optional[float] = None
    # Exact rational BFS + objective when certification ran.
    exact_bfs: Optional[SparseVector] = None
    exact_objective: Optional[Fraction] = None
    # Exact duals (simplex multipliers y, one per structural row).
    exact_duals: Optional[List[Fraction]] = None
    # Final basis (provider column index per structural row).
    basis: Optional[List[int]] = None
    # First artificial column index when ``basis`` still contains
    # (zero-valued) artificials; None for an all-structural basis.
    art_offset: Optional[int] = None
    stats: SolveStats = field(default_factory=SolveStats)

    def is_optimal(self) -> bool:
        return self.status is SolveStatus.FINITE_OPTIMUM
