"""``module_from_reference`` against the port's own graph builders.

The reference builds each of the ten paper graphs; the port builds the same
graph with ``repro_torch.graphs`` starting from the same instruction id.
The carried-across module and the port-built one must agree instruction for
instruction: opcode, shape, dtype, attrs, wiring, id and name.
"""
import itertools

import numpy as np
import pytest

from graphs import ALL_GRAPHS as REF_GRAPHS
from graphs import random_feeds as ref_random_feeds
from repro_torch import graphs as port_graphs
from repro_torch.core import ir as tir
from repro_torch.core.interop import module_from_reference


def _same_attr(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (
            isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
            and a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
        )
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", list(REF_GRAPHS))
def test_carried_module_equals_port_graph(name, monkeypatch):
    ref = REF_GRAPHS[name]()
    carried = module_from_reference(ref)
    monkeypatch.setattr(tir, "_uid", itertools.count(ref.instructions[0].id))
    built = port_graphs.ALL_GRAPHS[name]()
    assert carried.name == built.name == ref.name
    assert len(carried.instructions) == len(built.instructions) == len(ref.instructions)
    for c, p in zip(carried.instructions, built.instructions, strict=True):
        assert (c.id, c.name, c.opcode, c.shape) == (p.id, p.name, p.opcode, p.shape)
        assert c.dtype == p.dtype and isinstance(c.dtype, np.dtype)
        assert [o.id for o in c.operands] == [o.id for o in p.operands]
        assert [u.id for u in c.users] == [u.id for u in p.users]
        assert set(c.attrs) == set(p.attrs)
        for k in c.attrs:
            assert _same_attr(c.attrs[k], p.attrs[k]), (c.name, k)
    assert [p.name for p in carried.parameters] == [p.name for p in built.parameters]
    assert [r.name for r in carried.roots] == [r.name for r in built.roots]
    # the same seeded feeds, drawn by either package
    a = ref_random_feeds(ref, np.random.RandomState(3))
    b = port_graphs.random_feeds(built, np.random.RandomState(3))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_carrying_moves_the_id_counter_past_the_taken_ids():
    ref = REF_GRAPHS["LR"]()
    carried = module_from_reference(ref)
    top = max(i.id for i in carried.instructions)
    fresh = tir.GraphBuilder("after").parameter("z", (2,), np.float32)
    assert fresh.instr.id > top
