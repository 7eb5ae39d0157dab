"""On the card: one short run of each cell through the harness, correct
and with its metrics (``python -m pytest portbench/tests -m card``)."""

import json
import time

import pytest

from portbench import harness
from portbench import run as runmod
from portbench.tests import tiny


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in
                                  tiny.manifest()["workloads"]])
def test_a_short_run_of_each_cell(card, name):
    cell = harness.load_cell(name)
    line, compared = runmod.measure(cell, 2 ** 31 + 17, 2.0, False, [card],
                                    time.monotonic())
    out = json.loads(line)
    assert out["correct"], compared
    assert {m["name"] for m in cell.end_to_end()} == set(out["metrics"])
    assert out["device"]["platform"] == "gpu"
