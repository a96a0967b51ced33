"""Exact solver (Dixon lifting) tests — the rational-arithmetic oracle layer
(reference analog: relp-num exact arithmetic; random-matrix identity tests
mirror decomposition/mod.rs:454-651)."""

import random
from fractions import Fraction

import pytest

from relp_tpu.exact.dixon import (
    ExactSingularError,
    _modinv_matrix,
    _modinv_matrix_numpy,
    exact_solve,
    exact_solve_transpose,
)

import numpy as np

F = Fraction


def _random_sparse_columns(rng, m, density=0.4, denominator_pool=(1, 2, 3, 7)):
    columns = []
    for j in range(m):
        col = []
        for i in range(m):
            if rng.random() < density or i == j:
                num = rng.randint(-9, 9)
                if num == 0:
                    num = 1
                den = rng.choice(denominator_pool)
                col.append((i, F(num, den)))
        columns.append(col)
    return columns


def _naive_solve(columns, b):
    """Fraction Gaussian elimination oracle."""
    m = len(b)
    A = [[F(0)] * m for _ in range(m)]
    for j, col in enumerate(columns):
        for i, v in col:
            A[i][j] = v
    x = list(b)
    # forward elimination with partial pivoting by nonzero
    aug = [row[:] + [x[i]] for i, row in enumerate(A)]
    for k in range(m):
        piv = next((i for i in range(k, m) if aug[i][k] != 0), None)
        if piv is None:
            raise ZeroDivisionError("singular")
        aug[k], aug[piv] = aug[piv], aug[k]
        inv = 1 / aug[k][k]
        aug[k] = [v * inv for v in aug[k]]
        for i in range(m):
            if i != k and aug[i][k] != 0:
                f = aug[i][k]
                aug[i] = [a - f * b_ for a, b_ in zip(aug[i], aug[k])]
    return [aug[i][m] for i in range(m)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_exact_solve_random(seed):
    rng = random.Random(seed)
    m = 12
    columns = _random_sparse_columns(rng, m)
    b = [F(rng.randint(-20, 20), rng.choice((1, 2, 5))) for _ in range(m)]
    x = exact_solve(columns, b)
    assert x == _naive_solve(columns, b)


def test_exact_solve_transpose():
    rng = random.Random(7)
    m = 10
    columns = _random_sparse_columns(rng, m)
    c = [F(rng.randint(-5, 5)) for _ in range(m)]
    y = exact_solve_transpose(columns, c)
    # Verify B^T y = c exactly.
    for j, col in enumerate(columns):
        total = sum((v * y[i] for i, v in col), F(0))
        assert total == c[j]


def test_exact_solve_singular():
    columns = [[(0, F(1)), (1, F(1))], [(0, F(2)), (1, F(2))]]
    with pytest.raises(ExactSingularError):
        exact_solve(columns, [F(1), F(1)])


def test_exact_solve_big_rationals():
    """Entries engineered so the answer needs large numerators/denominators."""
    rng = random.Random(11)
    m = 8
    columns = _random_sparse_columns(
        rng, m, density=0.9, denominator_pool=(97, 89, 83, 101)
    )
    b = [F(rng.randint(1, 1000), 991) for _ in range(m)]
    x = exact_solve(columns, b)
    assert x == _naive_solve(columns, b)


def test_modinv_native_matches_numpy():
    rng = np.random.default_rng(5)
    p = 1_000_003
    m = 20
    A = rng.integers(0, p, size=(m, m), dtype=np.int64)
    native = _modinv_matrix(A.copy(), p)
    ref = _modinv_matrix_numpy(A.copy(), p)
    if native is None or ref is None:
        assert native is None and ref is None
        return
    assert np.array_equal(native, ref)
    assert np.array_equal((A @ native) % p, np.eye(m, dtype=np.int64) % p)


def test_replace_column_matches_fresh_solver():
    """Sherman-Morrison mod-p column replacement == rebuilding from scratch
    (the O(m^2) update behind the exact-cleanup loop)."""
    from relp_tpu.exact.dixon import ExactSolver

    rng = random.Random(3)
    m = 10
    columns = _random_sparse_columns(rng, m, density=0.6)
    solver = ExactSolver(columns)
    b = [F(rng.randint(-50, 50), rng.choice((1, 2, 5))) for _ in range(m)]

    # A chain of 6 replacements, including denominator-lcm growth (13ths).
    for step in range(6):
        r = rng.randrange(m)
        new_col = [
            (i, F(rng.randint(-9, 9) or 1, rng.choice((1, 2, 13))))
            for i in range(m)
            if rng.random() < 0.7 or i == r
        ]
        columns = list(columns)
        columns[r] = new_col
        solver = solver.replace_column(r, new_col)
        fresh = ExactSolver(columns)
        assert solver.solve(b) == fresh.solve(b), step
        # Duals path too (transposed reuses the updated inverse).
        assert solver.transposed().solve(b) == fresh.transposed().solve(b)


def test_exact_cleanup_many_pivots_from_wrong_basis():
    """A deliberately suboptimal (slack) starting basis forces the exact
    cleanup loop through 5+ pivots; the certified optimum must match the
    true LP optimum (exercises the carried Sherman-Morrison solver)."""
    from relp_tpu.config import SolverConfig
    from relp_tpu.exact.certify import exact_cleanup
    from relp_tpu.data.elements import (
        Objective,
        RangedConstraintRelation,
        VariableType,
    )
    from relp_tpu.data.general_form import GeneralForm, Variable
    from relp_tpu.linalg.sparse import SparseColumnMatrix

    # min -sum x_i  s.t.  x_i + x_{i+1} <= i + 2 (chain), x >= 0.
    m = 8
    rows = [
        [F(1) if j in (i, (i + 1) % m) else F(0) for j in range(m)]
        for i in range(m)
    ]
    gf = GeneralForm(
        objective=Objective.MINIMIZE,
        constraints=SparseColumnMatrix.from_dense(rows),
        constraint_types=[RangedConstraintRelation.less() for _ in range(m)],
        b=[F(i + 2) for i in range(m)],
        variables=[
            Variable(VariableType.CONTINUOUS, F(-1), F(0), None)
            for _ in range(m)
        ],
        variable_names=[f"x{j}" for j in range(m)],
    )
    counts = gf.standardize()
    data = gf.derive_matrix_data(counts)

    # Start from the all-slack basis: feasible (b >= 0) but far from optimal.
    n_real = data.nr_columns()
    slack_basis = [n_real - m + i for i in range(m)]
    cfg = SolverConfig(pad_to=8)
    basis, x, y, pivots, optimal = exact_cleanup(data, list(slack_basis), cfg)
    assert optimal
    assert pivots >= 5, pivots

    # Oracle: solve through the driver and compare exact objectives.
    from relp_tpu.simplex import solve_relaxation

    result = solve_relaxation(data, cfg)
    assert result.stats.certified
    objective = sum(
        data.cost_value(j) * x[i]
        for i, j in enumerate(basis)
        if j < n_real
    )
    assert objective == result.exact_objective


def test_exact_duals_satisfy_strong_duality():
    """Certified solves expose the exact simplex multipliers y; the standard
    form's rows are equalities, so strong duality holds exactly:
    y . [b;u;r] == the certified objective (AFIRO end-to-end)."""
    from fractions import Fraction

    from conftest import reference_problem
    from relp_tpu.config import SolverConfig
    from relp_tpu.io import load_general_form
    from relp_tpu.simplex.driver import solve_relaxation

    gf = load_general_form(reference_problem("netlib", "AFIRO.SIF"))
    counts = gf.standardize()
    md = gf.derive_matrix_data(counts)
    result = solve_relaxation(md, SolverConfig(pad_to=8))
    assert result.stats.certified
    assert result.exact_duals is not None
    rhs = md.right_hand_side()
    assert len(result.exact_duals) == len(rhs)
    assert sum(
        (y * b for y, b in zip(result.exact_duals, rhs)), Fraction(0)
    ) == result.exact_objective


def test_exact_cleanup_wall_clock_budget():
    """exact_cleanup_time_s caps a long cleanup walk: with a zero-second
    budget the walk stops not-optimal after the first pivot check, so the
    caller (certify_and_repair -> escalation ladder) retries with a
    cleaner basis instead of grinding O(m^2) exact pivots for hours
    (netlib CYCLE under noisy default-precision scans)."""
    from relp_tpu.config import SolverConfig
    from relp_tpu.exact.certify import exact_cleanup
    from relp_tpu.data.elements import (
        Objective,
        RangedConstraintRelation,
        VariableType,
    )
    from relp_tpu.data.general_form import GeneralForm, Variable
    from relp_tpu.linalg.sparse import SparseColumnMatrix

    m = 8
    rows = [
        [F(1) if j in (i, (i + 1) % m) else F(0) for j in range(m)]
        for i in range(m)
    ]
    gf = GeneralForm(
        objective=Objective.MINIMIZE,
        constraints=SparseColumnMatrix.from_dense(rows),
        constraint_types=[RangedConstraintRelation.less() for _ in range(m)],
        b=[F(i + 2) for i in range(m)],
        variables=[
            Variable(VariableType.CONTINUOUS, F(-1), F(0), None)
            for _ in range(m)
        ],
        variable_names=[f"x{j}" for j in range(m)],
    )
    counts = gf.standardize()
    data = gf.derive_matrix_data(counts)
    n_real = data.nr_columns()
    slack_basis = [n_real - m + i for i in range(m)]

    cfg = SolverConfig(pad_to=8, exact_cleanup_time_s=1e-9)
    basis, x, y, pivots, optimal = exact_cleanup(data, list(slack_basis), cfg)
    assert not optimal
    assert pivots <= 1

    # An ample budget still reaches the exact optimum (same fixture as
    # test_exact_cleanup_many_pivots_from_wrong_basis).
    cfg = SolverConfig(pad_to=8, exact_cleanup_time_s=600.0)
    _, _, _, pivots, optimal = exact_cleanup(data, list(slack_basis), cfg)
    assert optimal and pivots >= 5


class _TinyProvider:
    """Minimal standard-form provider for certify-layer unit tests."""

    def __init__(self, columns, b, costs):
        self._columns = columns  # list of [(row, Fraction)]
        self._b = b
        self._costs = costs

    def column(self, j):
        from relp_tpu.providers.column import SparseColumn

        return SparseColumn(self._columns[j])

    def cost_value(self, j):
        return self._costs[j]

    def right_hand_side(self):
        return list(self._b)

    def nr_columns(self):
        return len(self._columns)

    def nr_rows(self):
        return len(self._b)


def test_exact_dual_cleanup_proves_infeasible():
    """A dual-feasible basis with an exactly negative basic value and no
    negative pivot entry: the exact dual simplex must prove INFEASIBLE
    (the float path shipped this as an uncertified 'optimum' — the seed-62
    infinite branch loop in the exact MIP fuzz suite)."""
    from relp_tpu.config import SolverConfig
    from relp_tpu.exact.certify import certify_and_repair, exact_dual_cleanup
    from relp_tpu.simplex.result import (
        OptimizationResult,
        SolveStatus,
        SolveStats,
    )

    # min x1  s.t.  x0 + x1 = -1, x >= 0: exactly infeasible.
    prov = _TinyProvider(
        [[(0, F(1))], [(0, F(1))]], [F(-1)], [F(0), F(1)]
    )
    cfg = SolverConfig(pad_to=8)
    basis, x, y, pivots, verdict = exact_dual_cleanup(prov, [0], cfg)
    assert verdict == "infeasible"
    assert x == [F(-1)]

    result = OptimizationResult(
        status=SolveStatus.FINITE_OPTIMUM, objective=0.0, stats=SolveStats()
    )
    certify_and_repair(result, prov, [0], cfg)
    assert result.status is SolveStatus.INFEASIBLE
    assert result.stats.certified
    assert result.objective is None


def test_exact_dual_cleanup_restores_feasibility():
    """A repairable primal infeasibility: one exact dual pivot restores
    x >= 0 and certify_and_repair ships the certified optimum."""
    from relp_tpu.config import SolverConfig
    from relp_tpu.exact.certify import certify_and_repair, exact_dual_cleanup
    from relp_tpu.simplex.result import (
        OptimizationResult,
        SolveStatus,
        SolveStats,
    )

    # min x0 + 3 x1  s.t.  x0 - x1 = -1, x >= 0: optimum x=(0,1), obj 3.
    prov = _TinyProvider(
        [[(0, F(1))], [(0, F(-1))]], [F(-1)], [F(1), F(3)]
    )
    cfg = SolverConfig(pad_to=8)
    basis, x, y, pivots, verdict = exact_dual_cleanup(prov, [0], cfg)
    assert verdict == "optimal"
    assert basis == [1] and x == [F(1)] and pivots == 1

    result = OptimizationResult(
        status=SolveStatus.FINITE_OPTIMUM, objective=0.0, stats=SolveStats()
    )
    certify_and_repair(result, prov, [0], cfg)
    assert result.status is SolveStatus.FINITE_OPTIMUM
    assert result.stats.certified
    assert result.exact_objective == F(3)


def test_adaptive_lift_early_exit_on_simple_solution():
    """A basis with huge entries has an astronomical Hadamard lift bound,
    but when the actual solution is simple the adaptive checkpoints must
    recover it from a few p-adic digits (the DFL001 certification fix).
    Correctness: the returned x must verify exactly either way."""
    import numpy as np

    from relp_tpu.exact.dixon import ExactSolver, _lift_bound

    rng = np.random.default_rng(5)
    m = 60
    M = rng.integers(-10**9, 10**9, size=(m, m))
    while abs(np.linalg.det(M.astype(float))) < 1e-3:
        M = rng.integers(-10**9, 10**9, size=(m, m))
    columns = [
        [(i, F(int(M[i, j]))) for i in range(m) if M[i, j]] for j in range(m)
    ]
    # Simple designed solution: x_j in {0, 1/2, 3}.
    x_true = [F(0), F(1, 2), F(3)] * (m // 3)
    b = [
        sum((F(int(M[i, j])) * x_true[j] for j in range(m)), F(0))
        for i in range(m)
    ]
    solver = ExactSolver(columns, peel=False)
    # The worst-case bound is huge (entries ~1e9, m=60: hundreds of digits);
    # the checkpointed lift should still answer exactly.
    assert _lift_bound(solver.int_columns, [int(v) for v in b], solver.p) > 100
    x = solver.solve(b)
    assert x == x_true


def test_btf_block_triangular_solve_matches_oracle():
    """Block-triangular (BTF) structural decomposition: a basis assembled
    from dense diagonal bumps + identity-like singleton columns + cross-block
    coupling entries must solve exactly (forward block substitution), for
    both B and B^T, matching the Fraction Gaussian elimination oracle."""
    from relp_tpu.exact.dixon import ExactSolver, _btf_order

    rng = random.Random(11)
    # Three dense bumps of sizes 4, 3, 5 on the diagonal, then 8 singleton
    # columns, with random coupling entries only from earlier blocks'
    # columns into later blocks' rows (keeps the matrix block-triangular
    # under SOME permutation; the solver must find it).
    sizes = [4, 3, 5]
    offsets = [0, 4, 7]
    m = sum(sizes) + 8
    columns = [[] for _ in range(m)]
    for blk, (sz, off) in enumerate(zip(sizes, offsets)):
        for j in range(off, off + sz):
            for i in range(off, off + sz):
                if rng.random() < 0.7 or i == j:
                    columns[j].append((i, F(rng.randint(1, 9), rng.choice((1, 2, 3)))))
            # coupling into later rows only
            for i in range(off + sz, m):
                if rng.random() < 0.2:
                    columns[j].append((i, F(rng.randint(-5, 5) or 1)))
    for k in range(8):
        j = sum(sizes) + k
        columns[j].append((j, F(rng.randint(1, 7), rng.choice((1, 5)))))

    # Scramble rows and columns so the structure is hidden.
    rperm = list(range(m))
    cperm = list(range(m))
    rng.shuffle(rperm)
    rng.shuffle(cperm)
    scrambled = [
        sorted((rperm[i], v) for i, v in columns[j]) for j in cperm
    ]

    solver = ExactSolver(scrambled, peel=True)
    assert solver.btf_blocks is not None, "BTF must engage on this structure"
    blocks = _btf_order(scrambled)
    assert max(len(c) for c, _ in blocks) <= max(sizes)

    b = [F(rng.randint(-20, 20), rng.choice((1, 3))) for _ in range(m)]
    assert solver.solve(b) == _naive_solve(scrambled, b)

    rows = [[] for _ in range(m)]
    for j, col in enumerate(scrambled):
        for i, v in col:
            rows[i].append((j, v))
    assert solver.transposed().solve(b) == _naive_solve(rows, b)


def test_btf_declines_irreducible_matrix():
    """A dense (single strongly connected block) matrix must keep the flat
    inverse so exact-cleanup's O(m^2) replace_column updates stay available."""
    from relp_tpu.exact.dixon import ExactSolver

    rng = random.Random(7)
    columns = _random_sparse_columns(rng, 10, density=0.8)
    solver = ExactSolver(columns)
    assert solver.btf_blocks is None
    b = [F(rng.randint(-9, 9)) for _ in range(10)]
    assert solver.solve(b) == _naive_solve(columns, b)
