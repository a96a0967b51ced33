"""MPS parser tests.

Fixture mirrors the reference's embedded test program semantics
(src/io/mps + src/tests/problem_1): rows are sorted by name, cost entries
keyed by column index, bounds applied with tightening semantics.
"""

from fractions import Fraction

import pytest

from relp_tpu.data.elements import ConstraintRelation, Objective, VariableType
from relp_tpu.io import mps_to_general_form, parse_fixed, parse_free
from relp_tpu.io.errors import Inconsistency, ParseError

SMALL = """* Comment line
NAME          TESTPROB
ROWS
 N  COST
 L  LIM1
 G  LIM2
 E  MYEQN
COLUMNS
    X1        COST         1.0   LIM1         1.0
    X1        LIM2         1.0
    X2        COST         2.0   LIM1         1.0
    X2        MYEQN       -1.0
    X3        COST        -1.0   MYEQN        1.0
RHS
    RHS1      LIM1         4.0   LIM2         1.0
    RHS1      MYEQN        7.0
BOUNDS
 UP BND1      X1           4.0
 LO BND1      X2          -1.0
ENDATA
"""


def test_parse_free_small():
    mps = parse_free(SMALL)
    assert mps.name == "TESTPROB"
    assert mps.objective is Objective.MINIMIZE
    assert mps.cost_row_name == "COST"
    # Rows sorted by name: LIM1, LIM2, MYEQN.
    assert [r.name for r in mps.rows] == ["LIM1", "LIM2", "MYEQN"]
    assert [r.constraint_type for r in mps.rows] == [
        ConstraintRelation.LESS,
        ConstraintRelation.GREATER,
        ConstraintRelation.EQUAL,
    ]
    assert [c.name for c in mps.columns] == ["X1", "X2", "X3"]
    assert mps.cost_values == [
        (0, Fraction(1)),
        (1, Fraction(2)),
        (2, Fraction(-1)),
    ]
    assert mps.columns[0].values == [(0, Fraction(1)), (1, Fraction(1))]
    assert mps.columns[1].values == [(0, Fraction(1)), (2, Fraction(-1))]
    assert mps.rhss[0].values == [
        (0, Fraction(4)),
        (1, Fraction(1)),
        (2, Fraction(7)),
    ]


def test_convert_small():
    gf = mps_to_general_form(parse_free(SMALL))
    assert gf.nr_constraints() == 3
    assert gf.nr_variables() == 3
    # X1: [0, 4]; X2: [-1, inf); X3: [0, inf) default
    assert gf.variables[0].lower_bound == 0
    assert gf.variables[0].upper_bound == 4
    assert gf.variables[1].lower_bound == -1
    assert gf.variables[1].upper_bound is None
    assert gf.variables[2].lower_bound == 0
    assert gf.variables[2].upper_bound is None
    assert gf.b == [Fraction(4), Fraction(1), Fraction(7)]


def test_integer_markers():
    text = """NAME          INTTEST
ROWS
 N  OBJ
 L  C1
COLUMNS
    MARKER1   'MARKER'  'INTORG'
    X1        OBJ          1.0   C1           1.0
    MARKER2   'MARKER'  'INTEND'
    X2        OBJ          1.0   C1           2.0
RHS
    R         C1           10.0
ENDATA
"""
    mps = parse_free(text)
    assert mps.columns[0].variable_type is VariableType.INTEGER
    assert mps.columns[1].variable_type is VariableType.CONTINUOUS


def test_objsense_maximize():
    text = """NAME          M
OBJSENSE
    MAX
ROWS
 N  OBJ
 G  C1
COLUMNS
    X         OBJ          1.0   C1           1.0
RHS
    R         C1           1.0
ENDATA
"""
    assert parse_free(text).objective is Objective.MAXIMIZE


def test_duplicate_row_name_errors():
    text = """NAME          D
ROWS
 N  OBJ
 L  C1
 L  C1
COLUMNS
    X         OBJ          1.0   C1           1.0
RHS
ENDATA
"""
    with pytest.raises(Inconsistency):
        parse_free(text)


def test_unknown_row_errors():
    text = """NAME          D
ROWS
 N  OBJ
 L  C1
COLUMNS
    X         NOPE         1.0
RHS
ENDATA
"""
    with pytest.raises(Inconsistency):
        parse_free(text)


def test_ranges_semantics():
    # G row with range r: b <= <a,x> <= b + |r|
    text = """NAME          R
ROWS
 N  OBJ
 G  C1
 L  C2
COLUMNS
    X         OBJ          1.0   C1           1.0
    X         C2           1.0
RHS
    R         C1           2.0   C2           8.0
RANGES
    RNG       C1           3.0   C2           5.0
ENDATA
"""
    gf = mps_to_general_form(parse_free(text))
    from relp_tpu.data.elements import RangedKind

    # C1: G row, range 3 -> 2 <= x <= 5, stored as Range(3) with b=5.
    assert gf.constraint_types[0].kind is RangedKind.RANGE
    assert gf.constraint_types[0].range == 3
    assert gf.b[0] == 5
    # C2: L row, range 5 -> 3 <= x <= 8, b stays at the L value 8.
    assert gf.constraint_types[1].kind is RangedKind.RANGE
    assert gf.constraint_types[1].range == 5
    assert gf.b[1] == 8


def test_parse_fixed_netlib(cpu_config):
    from tests.conftest import reference_problem

    path = reference_problem("netlib", "AFIRO.SIF")
    with open(path) as f:
        mps = parse_fixed(f.read())
    assert mps.name == "AFIRO"
    assert mps.nr_columns() == 32
    assert mps.nr_rows() == 27
    gf = mps_to_general_form(mps)
    assert gf.nr_variables() == 32
    assert gf.nr_constraints() == 27


def test_parse_error_location_chain():
    """Malformed files report the failing line AND the section path —
    the reference's nested Parse file-location chain (io/error.rs:70-237)."""
    bad_value = SMALL.replace("LIM2         1.0\n    X2", "LIM2         oops\n    X2")
    with pytest.raises(ParseError) as ei:
        parse_free(bad_value)
    msg = str(ei.value)
    assert "oops" in msg
    assert "while parsing the COLUMNS section" in msg
    assert "at line" in msg
    # The chain records the failing file location programmatically too.
    assert ei.value.locations and "oops" in ei.value.locations[0][1]

    bad_row = SMALL.replace(" G  LIM2", " Q  LIM2")
    with pytest.raises(ParseError) as ei:
        parse_free(bad_row)
    msg = str(ei.value)
    assert "Row type 'Q' unknown." in msg
    assert "while parsing the ROWS section" in msg

    bad_bound = SMALL.replace(" UP BND1      X1           4.0", " ZZ BND1      X1           4.0")
    with pytest.raises(ParseError) as ei:
        parse_free(bad_bound)
    msg = str(ei.value)
    assert "Bound type 'ZZ' unknown." in msg
    assert "while parsing the BOUNDS section" in msg

    truncated = SMALL.split("RHS1      MYEQN")[0]
    with pytest.raises(ParseError) as ei:
        parse_free(truncated)
    assert "while parsing the RHS section" in str(ei.value)


def test_import_file_frames_the_path(tmp_path):
    """import_file adds the outermost which-file frame to the chain."""
    from relp_tpu.io import import_file

    p = tmp_path / "bad.mps"
    p.write_text(SMALL.replace(" G  LIM2", " Q  LIM2"))
    with pytest.raises(ParseError) as ei:
        import_file(str(p), native=False)
    msg = str(ei.value)
    assert "while importing" in msg and "bad.mps" in msg
    assert "while parsing the ROWS section" in msg


def test_rhs_on_cost_row_is_objective_constant():
    """An RHS entry targeting the objective row sets the objective constant
    (constant = -rhs, the standard MPS convention), in both the free and the
    fixed-field parser.  BEYOND REFERENCE: the reference errors on such
    files (netlib GROW15/GROW22 carry such RHS sections)."""
    text = SMALL.replace(
        "    RHS1      LIM1         4.0   LIM2         1.0",
        "    RHS1      COST        -5.0   LIM1         4.0\n"
        "    RHS1      LIM2         1.0",
    )
    mps = parse_free(text)
    assert mps.objective_constant == Fraction(5)
    gf = mps_to_general_form(mps)
    assert gf.fixed_cost == Fraction(5)

    # Fixed-field parse (the netlib SIF layout): the same entry sets the
    # constant; without it the constant is 0.
    assert parse_fixed(FIXED).objective_constant == 0
    fixed = parse_fixed(
        FIXED.replace("RHS\n", "RHS\n    RHS       COST               2.5\n")
    )
    assert fixed.objective_constant == Fraction(-5, 2)
    assert fixed.nr_rows() == 2
    assert mps_to_general_form(fixed).fixed_cost == Fraction(-5, 2)


# Fixed-field layout: fields start at columns 2, 5, 15, 25, 40 and 50.
FIXED = """NAME          FIXEDCST
ROWS
 N  COST
 L  R1
 G  R2
COLUMNS
    X1        COST               1.0   R1                 1.0
    X1        R2                 1.0
    X2        COST               2.0   R1                 1.0
RHS
    RHS       R1                 4.0   R2                 1.0
ENDATA
"""
