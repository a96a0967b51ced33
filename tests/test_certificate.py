"""Exportable exact certificates + the independent verifier.

Beyond reference scope: the reference asserts exactness internally
(debug_assert_in_basic_feasible_solution_state, tableau/mod.rs:319-357);
here every verdict becomes a portable JSON artifact checkable with plain
rational arithmetic and no solver state.
"""

import json
from fractions import Fraction

import pytest

from relp_tpu.config import SolverConfig
from relp_tpu.data.elements import (
    Objective,
    RangedConstraintRelation,
)
from relp_tpu.data.general_form import GeneralForm, Variable, VariableType
from relp_tpu.exact.certificate import (
    export_certificate,
    load_certificate,
    save_certificate,
    verify_certificate,
)
from relp_tpu.linalg.sparse import SparseColumnMatrix
from relp_tpu.simplex import SolveStatus, solve_general_form

from conftest import reference_problem


def _gf(objective, rows, types, b, costs, bounds):
    variables = [
        Variable(
            variable_type=VariableType.CONTINUOUS,
            cost=Fraction(c),
            lower_bound=None if lo is None else Fraction(lo),
            upper_bound=None if hi is None else Fraction(hi),
        )
        for c, (lo, hi) in zip(costs, bounds)
    ]
    return GeneralForm(
        objective=objective,
        constraints=SparseColumnMatrix.from_dense(
            [[Fraction(v) for v in row] for row in rows]
        ),
        constraint_types=types,
        b=[Fraction(v) for v in b],
        variables=variables,
        variable_names=[f"x{j}" for j in range(len(costs))],
    )


def _roundtrip(cert):
    return json.loads(json.dumps(cert))


def test_optimal_certificate_netlib_roundtrip():
    from relp_tpu.io import load_general_form

    gf = load_general_form(reference_problem("netlib", "AFIRO.SIF"))
    result, solution = solve_general_form(gf, SolverConfig(pad_to=8))
    assert result.status is SolveStatus.FINITE_OPTIMUM
    provider = result.provider
    cert = _roundtrip(export_certificate(result, provider))
    assert cert["status"] == "finite_optimum"
    ok, reason = verify_certificate(provider, cert)
    assert ok, reason
    assert "zero gap" in reason

    # Tampering is caught: objective, a primal entry, a dual entry.
    bad = _roundtrip(cert)
    num, _, den = bad["objective"].partition("/")
    bad["objective"] = f"{int(num) + 1}/{den}"
    assert not verify_certificate(provider, bad)[0]

    bad = _roundtrip(cert)
    j = next(iter(bad["x"]))
    bad["x"][j] = "1/3"
    assert not verify_certificate(provider, bad)[0]

    bad = _roundtrip(cert)
    bad["y"][0] = "355/113"
    assert not verify_certificate(provider, bad)[0]


def test_infeasible_certificate_farkas():
    cfg = SolverConfig(pad_to=8, presolve=False)
    gf = _gf(
        Objective.MINIMIZE,
        [[1, 1], [1, 1]],
        [RangedConstraintRelation.less(), RangedConstraintRelation.greater()],
        [1, 3],
        [1, 1],
        [(0, None), (0, None)],
    )
    result, _ = solve_general_form(gf, cfg)
    assert result.status is SolveStatus.INFEASIBLE and result.stats.certified
    cert = _roundtrip(export_certificate(result, result.provider))
    assert cert["status"] == "infeasible"
    ok, reason = verify_certificate(result.provider, cert)
    assert ok, reason

    bad = _roundtrip(cert)
    bad["y"] = ["0/1"] * len(bad["y"])
    assert not verify_certificate(result.provider, bad)[0]


def test_unbounded_certificate_ray():
    # presolve=False: presolve would detect the unbounded direction itself
    # and return without a basis to certify from.
    cfg = SolverConfig(pad_to=8, presolve=False)
    gf = _gf(
        Objective.MINIMIZE,
        [[1, -1]],
        [RangedConstraintRelation.less()],
        [1],
        [-1, 0],
        [(0, None), (0, None)],
    )
    result, _ = solve_general_form(gf, cfg)
    assert result.status is SolveStatus.UNBOUNDED and result.stats.certified
    cert = _roundtrip(export_certificate(result, result.provider))
    assert cert["status"] == "unbounded"
    ok, reason = verify_certificate(result.provider, cert)
    assert ok, reason

    bad = _roundtrip(cert)
    bad["ray"] = {j: "0/1" for j in bad["ray"]}
    assert not verify_certificate(result.provider, bad)[0]


def test_certificate_rejects_wrong_problem():
    """A certificate for one LP is rejected against another."""
    from relp_tpu.io import load_general_form

    gf = load_general_form(reference_problem("netlib", "AFIRO.SIF"))
    result, _ = solve_general_form(gf, SolverConfig(pad_to=8))
    cert = _roundtrip(export_certificate(result, result.provider))

    gf2 = load_general_form(reference_problem("netlib", "SC50A.SIF"))
    result2, _ = solve_general_form(gf2, SolverConfig(pad_to=8))
    ok, reason = verify_certificate(result2.provider, cert)
    assert not ok
    assert "mismatch" in reason or "range" in reason


def test_certificate_cli_roundtrip(tmp_path):
    """python -m relp_tpu solve --certificate + verify."""
    import subprocess
    import sys

    import os

    from relp_tpu.data import facility

    problem = tmp_path / "cfl.mps"
    problem.write_text(facility.to_mps(facility.generate(5, 4, seed=0)))
    cert_path = tmp_path / "cfl.cert.json"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "relp_tpu", "solve", str(problem),
         "--certificate", str(cert_path)],
        capture_output=True, text=True, env=env, cwd=repo,
    )
    assert out.returncode == 0, out.stderr
    cert = load_certificate(str(cert_path))
    assert cert["status"] == "finite_optimum"
    out = subprocess.run(
        [sys.executable, "-m", "relp_tpu", "verify", str(problem),
         str(cert_path)],
        capture_output=True, text=True, env=env, cwd=repo,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "VERIFIED" in out.stdout

    # A tampered certificate is rejected through the CLI too.
    cert["objective"] = "1/1"
    save_certificate(str(cert_path), cert)
    out = subprocess.run(
        [sys.executable, "-m", "relp_tpu", "verify", str(problem),
         str(cert_path)],
        capture_output=True, text=True, env=env, cwd=repo,
    )
    assert out.returncode == 1
    assert "REJECTED" in out.stdout


def test_certificate_after_rank_repair():
    """A rank-repaired solve's certificate refers to the row-filtered
    provider the basis actually indexes (result.provider), and verifies.
    Regression: solve_relaxation used to clobber result.provider with the
    unreduced input provider, producing a certificate the verifier itself
    rejected ('duals have wrong length')."""
    cfg = SolverConfig(pad_to=8, presolve=False)
    gf = _gf(
        Objective.MINIMIZE,
        [[1, 1], [1, 1], [1, -1]],
        [
            RangedConstraintRelation.equal(),
            RangedConstraintRelation.equal(),
            RangedConstraintRelation.equal(),
        ],
        [4, 4, 0],
        [1, 2],
        [(0, None), (0, None)],
    )
    result, solution = solve_general_form(gf, cfg)
    assert result.status is SolveStatus.FINITE_OPTIMUM
    assert result.stats.removed_rows
    cert = _roundtrip(export_certificate(result, result.provider))
    ok, reason = verify_certificate(result.provider, cert)
    assert ok, reason


def test_verifier_total_on_malformed_certificates():
    """Adversarial/truncated JSON is REJECTED with a reason, never raised."""
    from relp_tpu.io import load_general_form

    gf = load_general_form(reference_problem("netlib", "AFIRO.SIF"))
    result, _ = solve_general_form(gf, SolverConfig(pad_to=8))
    provider = result.provider
    good = _roundtrip(export_certificate(result, provider))

    mutations = [
        {"format": "bogus"},
        {"x": "oops"},
        {"x": {"0": "abc"}},
        {"y": "not-a-list"},
        {"y": ["1/1", None]},
        {"objective": None},
        {"status": "sideways"},
        {"x": {str(10**6): "1/1"}},
    ]
    for mut in mutations:
        bad = _roundtrip(good)
        bad.update(mut)
        ok, reason = verify_certificate(provider, bad)
        assert not ok, mut
        assert isinstance(reason, str) and reason
