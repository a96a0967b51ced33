"""CLI (`python -m relp_tpu solve`) — mirror of the reference's relp-bin
companion crate (SURVEY.md §5: CLI)."""

import json
import os

import pytest

from relp_tpu.__main__ import main

DATA = os.path.join(os.path.dirname(__file__), "data")
# min -x - y s.t. x + 2y <= 4, 3x + y <= 9: optimum -17/5 at (14/5, 3/5).
TWOVAR = os.path.join(DATA, "twovar.mps")


def test_cli_lp_json(capsys):
    rc = main(["solve", "--json", "--values", TWOVAR])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert out["status"] == "finite_optimum"
    assert out["objective"] == "-17/5"
    assert out["certified"] is True
    assert out["values"] == {"X": "14/5", "Y": "3/5"}


def test_cli_mip_json(capsys):
    rc = main(
        [
            "solve",
            "--mip",
            "--json",
            "--values",
            os.path.join(DATA, "knap6.mps"),
        ]
    )
    out = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert out["status"] == "finite_optimum"
    assert out["objective"] == "-30"  # knapsack optimum 30, minimize sense
    assert out["certified"] is True
    assert out["gap"] == "0"
    assert out["best_bound"] == "-30"
    picked = {k: v for k, v in out["values"].items() if v != "0"}
    assert all(v == "1" for v in picked.values())


def test_cli_mip_gap_and_limits(capsys):
    rc = main(
        [
            "solve", "--mip", "--json", "--gap", "0.5",
            "--time-limit", "120", "--branching", "most_fractional",
            "--cut-rounds", "1",
            os.path.join(DATA, "knap6.mps"),
        ]
    )
    out = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert out["status"] == "finite_optimum"


def test_cli_first_order_json(capsys):
    rc = main(["solve", "--first-order", "--json", TWOVAR])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert out["status"] == "finite_optimum"
    assert out["objective"] == "-17/5"
    assert out["certified"] is True
