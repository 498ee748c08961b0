"""A run whose timed path is broken underneath reads ``correct`` false: the
harness is driven on the CPU without its look for a card, through a
``stitch`` whose layer outputs carry each fault a cell of this benchmark
can have.  (The cells run on one card, so there is no exchange between
chips to leave out.)"""
import json
import time

import pytest
import torch

from repro_torch import stitch as real_stitch
from stitchbench import harness
from stitchbench_cells import WORKLOADS, small_cell

#: the limit at these small widths (see test_stitchbench_program.CPU_TOL)
CPU_TOL = 2e-4
F32 = [w for w in WORKLOADS if "-bf16." not in w]


def unchanged(x, y):
    """The layer returns its input unchanged: it adds nothing."""
    return x.clone()


def half_batch(x, y, batch):
    """The second half of the batch's sequences left out (passed through)."""
    y = y.clone()
    rows = y.shape[0] // batch * (batch // 2)
    y[rows:] = x[rows:]
    return y


def altered(x, y):
    """One answer altered where it is produced, by a tenth of the widest
    change the layer makes."""
    y = y.clone()
    y[y.shape[0] // 3, 5] += 0.1 * float((y - x).abs().max())
    return y


class Faulty:
    """A stitched function whose outputs pass through ``fault``."""

    def __init__(self, sf, fault):
        self.sf, self.fault = sf, fault

    def __call__(self, x, *rest):
        return self.fault(x, self.sf(x, *rest))

    def __getattr__(self, name):
        return getattr(self.sf, name)


def _run(workload, fault, traced=False):
    cell = small_cell(workload, batch=4, seq=16)
    cell.limits = {"out_err": {"limit": CPU_TOL}}
    if fault is half_batch:
        fault = lambda x, y: half_batch(x, y, cell.batch)  # noqa: E731
    stitch = real_stitch if fault is None else (
        lambda fn, **kw: Faulty(real_stitch(fn, **kw), fault))
    result, _ = harness.run_cell(cell, 2**32 + 5, 0.1, traced, torch.device("cpu"),
                                 time.perf_counter(), stitch=stitch)
    return result


@pytest.mark.parametrize("workload", F32)
def test_a_sound_run_is_correct(workload):
    assert _run(workload, None)["correct"]


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
@pytest.mark.parametrize("workload", F32)
def test_a_fault_is_not_correct(workload, fault):
    result = _run(workload, fault)
    assert not result["correct"]
    assert result["checks"]["out_err"]["value"] > CPU_TOL


def test_a_traced_run_is_judged_alike():
    assert not _run(F32[0], altered, traced=True)["correct"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_limit_lies_between_its_readings(workload):
    limits = json.loads((harness.HERE / "limits" / f"{workload}.json").read_text())["limits"]
    for name, lim in limits.items():
        assert max(lim["lower"]) < lim["limit"] < min(lim["upper"]), name
        assert min(lim["upper"]) >= 3 * max(lim["lower"]), name
