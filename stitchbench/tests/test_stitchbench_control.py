"""The control, on the card: the reference computed in the precision below
the configuration's, put in the program's place, fails the limit that the
program passes (every layer of each cell over one 512-token sequence,
through ``harness.control_readings``, the loop that sets the limits)."""
import json

import pytest

from stitchbench import harness
from stitchbench_cells import BENCH, WORKLOADS


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_where_the_program_passes(card, workload):
    cell = harness.load_cell(workload, BENCH)
    cell.traffic = dict(cell.traffic, batch=1, seq=512, distinct_inputs=2)
    for seed, prog, ctl in harness.control_readings(cell, (11, 12, 13), card):
        print(json.dumps({"seed": seed, "program": prog, "control": ctl}))
        assert all(prog[k] <= lim["limit"] for k, lim in cell.limits.items())
        assert any(ctl[k] > lim["limit"] for k, lim in cell.limits.items())
