"""Scale-out tests: scenario batches and column sharding on the virtual
8-device CPU mesh."""

from fractions import Fraction

import numpy as np
import pytest

from relp_tpu.config import SolverConfig
from relp_tpu.data.elements import Objective, RangedConstraintRelation
from relp_tpu.data.general_form import GeneralForm, Variable, VariableType
from relp_tpu.linalg.sparse import SparseColumnMatrix
from relp_tpu.simplex import SolveStatus

F = Fraction


def _provider(b2):
    """min -x - y st x + 2y <= 4, 3x + y <= b2 (perturbable)."""
    gf = GeneralForm(
        objective=Objective.MINIMIZE,
        constraints=SparseColumnMatrix.from_dense(
            [[F(1), F(2)], [F(3), F(1)]]
        ),
        constraint_types=[
            RangedConstraintRelation.less(),
            RangedConstraintRelation.less(),
        ],
        b=[F(4), F(b2)],
        variables=[
            Variable(VariableType.CONTINUOUS, F(-1), F(0), None),
            Variable(VariableType.CONTINUOUS, F(-1), F(0), None),
        ],
        variable_names=["x", "y"],
    )
    counts = gf.standardize()
    return gf.derive_matrix_data(counts), gf


def test_solve_batch_scenarios(cpu_config):
    from relp_tpu.parallel.batch_driver import solve_batch

    scenarios = [6, 7, 8, 9]
    providers = []
    for b2 in scenarios:
        md, _ = _provider(b2)
        providers.append(md)
    results = solve_batch(providers, cpu_config)
    assert len(results) == 4
    for b2, result in zip(scenarios, results):
        assert result.status is SolveStatus.FINITE_OPTIMUM, b2
        assert result.stats.certified
        # optimum of max x+y st x+2y<=4, 3x+y<=b2 at intersection:
        # x=(2 b2-4)/5, y=(12-b2)/5 for b2 in [2,12] -> obj -(b2+8)/5.
        assert result.exact_objective == -F(b2 + 8, 5)


def test_solve_batch_mixed_phase1(cpu_config):
    """Batch where some LPs need phase 1 (equality rows) and some don't."""
    from relp_tpu.parallel.batch_driver import solve_batch

    def eq_provider(rhs):
        gf = GeneralForm(
            objective=Objective.MINIMIZE,
            constraints=SparseColumnMatrix.from_dense(
                [[F(1), F(1)], [F(1), F(-1)]]
            ),
            constraint_types=[
                RangedConstraintRelation.equal(),
                RangedConstraintRelation.greater(),
            ],
            b=[F(rhs), F(2)],
            variables=[
                Variable(VariableType.CONTINUOUS, F(2), F(0), None),
                Variable(VariableType.CONTINUOUS, F(3), F(0), None),
            ],
            variable_names=["x", "y"],
        )
        counts = gf.standardize()
        return gf.derive_matrix_data(counts)

    md_ineq, _ = _provider(6)
    providers = [eq_provider(10), md_ineq, eq_provider(8)]
    results = solve_batch(providers, cpu_config)
    assert results[0].exact_objective == F(20)
    assert results[1].exact_objective == -F(14, 5)
    assert results[2].exact_objective == F(16)


def test_column_sharded_chunk(cpu_config):
    """Column-sharded pricing on an 8-device mesh gives the same pivots."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")

    import jax.numpy as jnp

    from relp_tpu.parallel.mesh import make_mesh
    from relp_tpu.parallel.sharded import shard_problem, shard_state
    from relp_tpu.simplex import kernels
    from relp_tpu.simplex.engine import DenseEngine
    from relp_tpu.simplex.lowering import lower_provider

    md, _ = _provider(6)
    problem = lower_provider(md, pad_to=8)  # f64 arrays
    engine = DenseEngine()
    cfg64 = SolverConfig(pad_to=8, dtype="float64")
    state = engine.init_state(problem, cfg64)

    A = jnp.asarray(problem.A)
    c = jnp.asarray(problem.c_phase2)
    cand = jnp.asarray(problem.candidate_mask)
    kwargs = dict(
        pricing=kernels.PRICE_DANTZIG,
        chunk=30,
        opt_tol=1e-9,
        pivot_tol=1e-9,
        degen_tol=1e-9,
    )
    plain = kernels.run_chunk(state, A, A, c, cand, **kwargs)

    mesh = make_mesh((1, 8))
    with mesh:
        A_s, b_s, c_s, cand_s = shard_problem(
            mesh, A, jnp.asarray(problem.b), c, cand
        )
        state_s = shard_state(mesh, engine.init_state(problem, cfg64))
        sharded = kernels.run_chunk(state_s, A_s, A_s, c_s, cand_s, **kwargs)

    assert int(sharded.iteration) == int(plain.iteration)
    assert np.array_equal(np.asarray(sharded.basis), np.asarray(plain.basis))
    assert np.allclose(np.asarray(sharded.xB), np.asarray(plain.xB))


def test_driver_with_mesh(cpu_config):
    """End-to-end solve through the driver with a column-sharded mesh."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from relp_tpu.parallel.mesh import make_mesh
    from relp_tpu.simplex import solve_relaxation

    md, _ = _provider(6)
    plain = solve_relaxation(md, cpu_config)
    mesh = make_mesh((1, 8))
    sharded = solve_relaxation(md, cpu_config, mesh=mesh)
    assert sharded.status is plain.status
    assert sharded.exact_objective == plain.exact_objective
    assert sharded.basis == plain.basis


def test_sharded_batch_driver(cpu_config):
    """solve_batch over a batch x col mesh reproduces the unsharded batch
    results exactly (dp x tp composed in the real driver)."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from relp_tpu.parallel.batch_driver import solve_batch
    from relp_tpu.parallel.mesh import make_mesh

    scenarios = [6, 7, 8, 9]
    plain = solve_batch([_provider(b2)[0] for b2 in scenarios], cpu_config)
    mesh = make_mesh((2, 4))
    sharded = solve_batch(
        [_provider(b2)[0] for b2 in scenarios], cpu_config, mesh=mesh
    )
    for b2, rp, rs in zip(scenarios, plain, sharded):
        assert rs.status is rp.status, b2
        assert rs.exact_objective == rp.exact_objective == -F(b2 + 8, 5)
        assert rs.basis == rp.basis, b2
        assert rs.stats.iterations == rp.stats.iterations, b2


def _netlib_matrix_data(name):
    from tests.conftest import reference_problem
    from relp_tpu.io import mps_to_general_form, parse_fixed

    path = reference_problem("netlib", name)
    with open(path) as f:
        mps = parse_fixed(f.read())
    gf = mps_to_general_form(mps)
    gf.presolve()
    counts = gf.standardize()
    return gf.derive_matrix_data(counts), gf


@pytest.mark.parametrize("name,expected", [
    ("SCAGR7.SIF", -2.331389824e06),
    ("SCTAP1.SIF", 0.141225e4),
])
def test_driver_with_mesh_netlib(name, expected):
    """Full-driver sharded-vs-single equivalence at netlib scale: the
    column-sharded 8-device solve must walk the same pivot path (same
    iteration count, same final basis) and certify the same objective.

    Reference semantic anchor: the pricing scan being parallelized,
    strategy/pivot_rule.rs:221-296."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from relp_tpu.parallel.mesh import make_mesh
    from relp_tpu.simplex import solve_relaxation

    md, gf = _netlib_matrix_data(name)
    cfg = SolverConfig(pad_to=64, chunk_size=100, refactor_period=100,
                       dtype="float64", scan_dtype="float32")
    plain = solve_relaxation(md, cfg)
    assert plain.status is SolveStatus.FINITE_OPTIMUM
    mesh = make_mesh((1, 8))
    sharded = solve_relaxation(md, cfg, mesh=mesh)
    assert sharded.status is SolveStatus.FINITE_OPTIMUM
    assert sharded.stats.certified and plain.stats.certified
    assert sharded.exact_objective == plain.exact_objective
    assert sharded.basis == plain.basis
    assert sharded.stats.iterations == plain.stats.iterations
    # Reconstructed full-problem objective matches the published optimum.
    reduced = md.reconstruct_solution(sharded.exact_bfs)
    solution = gf.compute_full_solution_with_reduced_solution(reduced)
    assert abs(float(solution.objective_value) - expected) < 1e-2


def test_sharded_pivot_sequence_netlib():
    """Chunk-by-chunk pivot-sequence equality on a real netlib problem:
    after every 10-pivot chunk the sharded and unsharded runs must hold
    bitwise-identical bases (not just the same endpoint)."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    import jax.numpy as jnp

    from relp_tpu.parallel.mesh import make_mesh
    from relp_tpu.parallel.sharded import shard_problem, shard_state
    from relp_tpu.simplex import kernels
    from relp_tpu.simplex.engine import DenseEngine
    from relp_tpu.simplex.lowering import lower_provider

    md, _ = _netlib_matrix_data("SCAGR7.SIF")
    problem = lower_provider(md, pad_to=64)  # f64
    engine = DenseEngine()
    cfg64 = SolverConfig(pad_to=64, dtype="float64")
    kwargs = dict(
        pricing=kernels.PRICE_DANTZIG,
        chunk=10,
        opt_tol=1e-9,
        pivot_tol=1e-9,
        degen_tol=1e-9,
        stop_at_zero=True,
    )

    A = jnp.asarray(problem.A)
    b = jnp.asarray(problem.b)
    c1 = jnp.asarray(problem.c_phase1)
    cand = jnp.asarray(problem.candidate_mask)
    plain = engine.init_state(problem, cfg64)

    mesh = make_mesh((1, 8))
    with mesh:
        A_s, b_s, c_s, cand_s = shard_problem(mesh, A, b, c1, cand)
        sharded = shard_state(mesh, engine.init_state(problem, cfg64))

    for _ in range(8):  # 80 phase-1 pivots, compared every 10
        plain = kernels.run_chunk(plain, A, A, c1, cand, **kwargs)
        with mesh:
            sharded = kernels.run_chunk(
                sharded, A_s, A_s, c_s, cand_s, **kwargs
            )
        assert int(sharded.iteration) == int(plain.iteration)
        assert np.array_equal(
            np.asarray(sharded.basis), np.asarray(plain.basis)
        )
        if int(plain.status) != 0:
            break
    assert int(plain.iteration) > 0


def test_newton_refresh_matches_refactorize():
    """Newton-Schulz refresh from a drifted inverse reaches the same basis
    quantities as a fresh factorization (kernels.newton_refresh — the
    matmul-only replacement for batched linalg.inv in the batch driver)."""
    import jax.numpy as jnp

    from relp_tpu.simplex import kernels

    rng = np.random.default_rng(5)
    M, N = 16, 40
    A = rng.standard_normal((M, N))
    A[:, N - M:] = np.eye(M)
    b = np.abs(rng.standard_normal(M))
    c = rng.standard_normal(N)
    basis = np.asarray(rng.choice(N, M, replace=False), np.int32)
    B = A[:, basis]
    exact = np.linalg.inv(B)
    drifted = exact + 1e-4 * rng.standard_normal((M, M))

    X, xB, pi, obj, residual = kernels.newton_refresh(
        jnp.asarray(drifted), jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
        jnp.asarray(basis), steps=3,
    )
    assert float(residual) < 1e-8
    Xr, xBr, pir, objr, resr = kernels.refactorize(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(c), jnp.asarray(basis),
        newton_steps=3,
    )
    np.testing.assert_allclose(np.asarray(xB), np.asarray(xBr), atol=1e-8)
    np.testing.assert_allclose(np.asarray(pi), np.asarray(pir), atol=1e-8)
    assert abs(float(obj) - float(objr)) < 1e-8


def test_device_cadence_batched_chunk(cpu_config):
    """batched_run_chunk with the on-device refactorization cadence reaches
    the same per-LP optima as the host-cadence path."""
    import dataclasses

    from relp_tpu.parallel.batch_driver import solve_batch

    providers = [_provider(6 + s)[0] for s in range(4)]
    cfg = dataclasses.replace(cpu_config, pad_to=8)
    base = solve_batch(providers, cfg, certify=True)

    # Drive the raw chunk runner with device cadence on the same problems.
    import jax.numpy as jnp

    from relp_tpu.parallel.batch import batched_run_chunk, make_batch_state
    from relp_tpu.simplex.engine import DenseEngine
    from relp_tpu.simplex.kernels import PRICE_STEEPEST
    from relp_tpu.simplex.lowering import lower_provider
    from relp_tpu.simplex.state import OPTIMAL

    engine = DenseEngine()
    max_rows = max(p.nr_rows() for p in providers)
    from relp_tpu.linalg.device import pad_to_multiple
    probe_M = pad_to_multiple(max_rows, 8)
    max_cols = max(p.nr_columns() + probe_M for p in providers)
    problems = [
        lower_provider(p, dtype=np.float32, pad_to=8, min_rows=max_rows,
                       min_cols=max_cols)
        for p in providers
    ]
    states = [engine.init_state(pr, cfg) for pr in problems]
    batch = make_batch_state(states)
    A = jnp.asarray(np.stack([pr.A for pr in problems]))
    b = jnp.asarray(np.stack([pr.b for pr in problems]))
    c1 = jnp.asarray(np.stack([pr.c_phase1 for pr in problems]))
    c2 = jnp.asarray(np.stack([pr.c_phase2 for pr in problems]))
    cand = jnp.asarray(np.stack([pr.candidate_mask for pr in problems]))
    kw = dict(pricing=PRICE_STEEPEST, chunk=400, opt_tol=cfg.opt_tol,
              pivot_tol=cfg.pivot_tol, degen_tol=cfg.feas_tol,
              refactor_period=10, b=b, feas_tol=cfg.feas_tol)
    batch = batched_run_chunk(batch, A, A, c1, cand, stop_at_zero=True, **kw)
    # phase transition: feasible LPs continue with real costs
    from relp_tpu.simplex.state import RUNNING
    import jax
    batch = batch._replace(
        status=jnp.where(np.asarray(batch.obj) <= 1e-6, RUNNING,
                         batch.status).astype(jnp.int32))
    from relp_tpu.simplex import kernels as K
    Binv, xB, pi, obj, _ = jax.vmap(
        lambda Bi, Aa, bb, cc, bs: K.newton_refresh(Bi, Aa, bb, cc, bs, steps=3),
        in_axes=(0, 0, 0, 0, 0),
    )(batch.Binv, A, b, c2, batch.basis)
    batch = batch._replace(Binv=Binv, xB=xB, pi=pi, obj=obj)
    batch = batched_run_chunk(batch, A, A, c2, cand, **kw)
    status = np.asarray(batch.status)
    assert (status == OPTIMAL).all()
    for k, r in enumerate(base):
        if r.objective is not None:
            assert abs(float(np.asarray(batch.obj)[k]) - r.objective) < 1e-4


def test_batch_f64_rescue_ill_conditioned_basis():
    """SHARE1B scenarios: every basis is the true optimum, but cond(B)~1e7
    makes the f32 from-scratch refactorization residual ~1e-3, which used to
    trip the 1e-4 numerics gate and push ALL LPs to the single-LP fallback.
    The f64 host rescue must keep them on the batch path (0 fallbacks) and
    match the cold single-LP objective."""
    import copy
    from fractions import Fraction

    from tests.conftest import reference_problem
    from relp_tpu.config import SolverConfig
    from relp_tpu.io import mps_to_general_form, parse_fixed
    from relp_tpu.parallel.batch_driver import solve_batch
    from relp_tpu.simplex import solve_relaxation
    from relp_tpu.simplex.result import SolveStatus

    path = reference_problem("netlib", "SHARE1B.SIF")
    with open(path) as f:
        gf = mps_to_general_form(parse_fixed(f.read()))
    gf.presolve()
    counts = gf.standardize()
    cfg = SolverConfig(pad_to=128, chunk_size=150, refactor_period=150)

    providers = []
    for s in range(3):
        pert = copy.deepcopy(gf)
        for i in range(len(pert.b)):
            wobble = Fraction((s * 7919 + i * 104729) % 2001 - 1000, 100_000)
            pert.b[i] = pert.b[i] * (1 + wobble)
        providers.append(pert.derive_matrix_data(counts))

    results = solve_batch(providers, cfg, certify=False, shared_structure=True)
    assert all(r.status is SolveStatus.FINITE_OPTIMUM for r in results)
    assert all(r.stats.chunks == 0 for r in results), "fell back to single-LP"
    for r, p in zip(results, providers):
        cold = solve_relaxation(p, cfg)
        assert abs(r.objective - cold.objective) <= 1e-5 * (
            1 + abs(cold.objective)
        )


def test_solve_batch_device_refactor_cadence():
    """solve_batch with SolverConfig.device_refactor: the in-chunk cadence
    (one dispatch carrying several refactor periods of pivots) reproduces
    the host-cadence verdicts and exact objectives on a netlib problem."""
    from relp_tpu.parallel.batch_driver import solve_batch

    md, _ = _netlib_matrix_data("SCAGR7.SIF")
    base = SolverConfig(pad_to=64, chunk_size=30, refactor_period=30)
    cadence = SolverConfig(
        pad_to=64, chunk_size=120, refactor_period=30, device_refactor=True
    )
    assert cadence.chunk_size == 120  # the clamp is skipped in this mode
    a = solve_batch([md], base, certify=True)
    md2, _ = _netlib_matrix_data("SCAGR7.SIF")
    b = solve_batch([md2], cadence, certify=True)
    assert a[0].status is SolveStatus.FINITE_OPTIMUM
    assert b[0].status is SolveStatus.FINITE_OPTIMUM
    assert a[0].stats.certified and b[0].stats.certified
    assert a[0].exact_objective == b[0].exact_objective


def _facility_problems(n, seed):
    from relp_tpu.data import facility
    from relp_tpu.simplex.lowering import lower_provider

    base = facility.generate(5, 4, seed=seed)
    rng = np.random.default_rng(seed)
    problems = []
    for _ in range(n):
        inst = facility.with_demand_scale(base, rng.integers(80, 121, size=5))
        gf = facility.general_form(inst)
        md = gf.derive_matrix_data(gf.standardize())
        problems.append(lower_provider(md, dtype=np.float32, pad_to=8))
    return problems


@pytest.mark.parametrize("stop_at_zero", [True, False])
def test_batched_chunk_matches_single_lp_pivots(stop_at_zero):
    """The vmapped batched chunk loop (the scenario driver's device path)
    takes exactly the per-LP pivots of the single-LP kernel: same basis,
    iteration count and status after each chunk, for phase 1 (stop at zero
    artificial cost) and for an uninterrupted walk."""
    import jax.numpy as jnp

    from relp_tpu.parallel.batch import batched_run_chunk, make_batch_state
    from relp_tpu.simplex import kernels
    from relp_tpu.simplex.engine import DenseEngine

    problems = _facility_problems(3, seed=7)
    cfg = SolverConfig(pad_to=8)
    engine = DenseEngine()
    kw = dict(
        pricing=kernels.PRICE_STEEPEST, chunk=15, opt_tol=1e-5,
        pivot_tol=1e-5, degen_tol=1e-5, stop_at_zero=stop_at_zero,
    )
    singles = []
    for pr in problems:
        st = engine.init_state(pr, cfg)
        A = jnp.asarray(pr.A)
        st = engine.recompute_gamma(st, A)
        singles.append((st, A, jnp.asarray(pr.c_phase1), jnp.asarray(pr.candidate_mask)))
    batch = make_batch_state([s[0] for s in singles])
    A_b = jnp.stack([s[1] for s in singles])
    c_b = jnp.stack([s[2] for s in singles])
    m_b = jnp.stack([s[3] for s in singles])
    states = [s[0] for s in singles]
    for _ in range(3):
        states = [
            kernels.run_chunk(st, A, A, c, m, **kw)
            for st, (_, A, c, m) in zip(states, singles)
        ]
        batch = batched_run_chunk(batch, A_b, A_b, c_b, m_b, **kw)
        for k, st in enumerate(states):
            assert np.array_equal(np.asarray(batch.basis[k]), np.asarray(st.basis))
            assert int(batch.iteration[k]) == int(st.iteration)
            assert int(batch.status[k]) == int(st.status)
    assert sum(int(st.iteration) for st in states) > 0


def test_multidevice_dryrun_on_four_devices():
    """__graft_entry__.dryrun_multichip on 4 of the virtual CPU devices:
    batch x col and column-sharded solves agree exactly with unsharded ones,
    and the sharded pivot sequence equals the single-device one."""
    import __graft_entry__

    lines = []
    out = __graft_entry__.dryrun_multichip(4, report=lines.append)
    assert out["pivot_sequence_equal"] and out["pivots_compared"] > 0
    assert out["batch_mesh"] == (2, 2)
    assert any("on devices [0, 1, 2, 3]" in line for line in lines)
