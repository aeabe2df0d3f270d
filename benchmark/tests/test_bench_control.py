"""On the card: the control comes out not correct where the program comes out
correct, at sizes a test run holds, on three seeds.

The control is the plain reference computed in TF32, the nearest precision
below the configurations' float32 with TF32 off, put in the program's place.
At the cells' own sizes ``controls.py`` reads it over a dozen seeds
(``limits/<workload>.json`` keeps the readings).
"""

import pytest

from benchmark import controls, harness
from conftest import tiny_cell

CELLS = [("cvppp.train_graphed", 256), ("ac3ac4.train_graphed", 64),
         ("ac3ac4.serve_affinity", 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,size", CELLS)
def test_the_control_is_not_correct(card, name, size):
    cell = tiny_cell(name, size)
    for seed in (1, 2, 3):
        row = controls.readings(cell, seed, 0.1)
        assert harness.check_limits(row["program"], cell.limits)[0], row
        control = dict(row["program"], **row["control"])
        assert not harness.check_limits(control, cell.limits)[0], row
