"""The limits of ``correct`` (``portbench/limits/<cell>.json``) against the
readings they were set from: each compared number's limit lies above its
lower reading (the largest of the program's sound seeds) and below its
upper one (the least the control or a fault gave); a training cell's
limit leaves its sound readings twice the room; each training cell names
the compared number that its fp8 control and the one that its half-batch
fault (planted before the forward and after it) read above the limit; and every number a driver reports has a limit
or is marked not compared."""

from __future__ import annotations

import os

import pytest

from conftest import ROOT, load
from portbench import checks
from portbench.drivers import train_steps

BENCH = load("..", "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
TRAIN = [w["name"] for w in BENCH["workloads"]
         if load("traffic", w["traffic"] + ".json")["driver"] == "train_steps"]


def _limits(cell: str) -> dict:
    return load("limits", cell + ".json")


def _compared(cell: str) -> dict:
    return {n: e for n, e in _limits(cell)["limits"].items() if e.get("compared") is not False}


def test_every_cell_has_its_limits():
    for cell in CELLS:
        assert os.path.exists(os.path.join(ROOT, "portbench", "limits", cell + ".json")), cell
    assert TRAIN


@pytest.mark.parametrize("cell", CELLS)
def test_each_limit_lies_between_its_readings(cell):
    for name, e in _compared(cell).items():
        if "exact" in e:
            assert e["limit"] == 0, name
        else:
            assert e["lower"] < e["limit"] < e["upper"], (cell, name, e)


@pytest.mark.parametrize("cell", TRAIN)
def test_a_training_limit_leaves_its_sound_readings_twice_the_room(cell):
    for name, e in _compared(cell).items():
        assert e["limit"] >= 2 * e["lower"], (cell, name, e)


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("what,reading", [("catches_control", "control"),
                                          ("catches_fault", "fault"),
                                          ("catches_fault", "loss_fault")])
def test_a_training_cell_names_what_catches_its_control_and_fault(cell, what, reading):
    name = _limits(cell)[what]
    e = _compared(cell)[name]
    assert float(e[reading]) > e["limit"], (cell, name, e)


@pytest.mark.parametrize("cell", TRAIN)
def test_every_training_number_has_a_limit_or_is_left_out(cell):
    """The numbers ``train_steps.compare`` reports, over readings that agree
    exactly, all pass under the cell's limits."""
    leaves = {"a": 1.0, "b": 2.0, "c": 3.0}
    side = {"loss": [5.0, 4.0, 3.0], "rows": [5.0, 6.0], "grad": leaves, "change": leaves}
    numbers, _ = train_steps.compare(side, dict(side), 1e-3)
    correct, got = checks.judge(numbers, _limits(cell)["limits"])
    assert correct and set(got) == set(_compared(cell)), got
