"""The port's data pipeline (``repro_torch.data``) against the reference's
(``repro.data``): every batch equal entry for entry, for each of the ten
families, across seeds, steps and shards; the prefetching iterator in
order."""
import numpy as np
import pytest

from repro import data as rdata
from repro.configs import ARCHITECTURES
from repro.configs import get_config as rget
from repro.configs import reduced_config as rreduced
from repro_torch import data as tdata
from repro_torch.configs import get_config, reduced_config


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_batches_equal_the_reference(arch):
    """Tokens and labels, and the VLM's ``patches`` and Whisper's
    ``frames``, bit for bit."""
    cfg, tcfg = rreduced(rget(arch)), reduced_config(get_config(arch))
    for seed, step, shard, shards in [(0, 0, 0, 1), (3, 11, 0, 1), (7, 5, 1, 2)]:
        want = rdata.SyntheticLM(cfg, 16, 4, seed, shard, shards).batch_at(step)
        got = tdata.SyntheticLM(tcfg, 16, 4, seed, shard, shards).batch_at(step)
        _equal(got, want)
    fam = tcfg.family
    assert ("patches" in got) == (fam == "vlm") and ("frames" in got) == (fam == "audio")


def test_full_width_batches_equal_the_reference():
    """At granite-moe-3b-a800m's own vocabulary (49,155 > 4,096: the stream
    wraps at 4,096) and sequence length."""
    want = rdata.SyntheticLM(rget("granite-moe-3b-a800m"), 512, 4, seed=0).batch_at(3)
    got = tdata.SyntheticLM(get_config("granite-moe-3b-a800m"), 512, 4, seed=0).batch_at(3)
    _equal(got, want)
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def test_data_pipeline_deterministic_per_step():
    cfg = reduced_config(get_config("qwen1.5-0.5b"))
    a = tdata.SyntheticLM(cfg, 16, 4, seed=3).batch_at(11)
    b = tdata.SyntheticLM(cfg, 16, 4, seed=3).batch_at(11)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = tdata.SyntheticLM(cfg, 16, 4, seed=3).batch_at(12)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_data_sharding_partitions_batch():
    cfg = reduced_config(get_config("qwen1.5-0.5b"))
    s0 = tdata.SyntheticLM(cfg, 8, 8, seed=0, shard=0, num_shards=2).batch_at(0)
    s1 = tdata.SyntheticLM(cfg, 8, 8, seed=0, shard=1, num_shards=2).batch_at(0)
    assert s0["tokens"].shape == (4, 8)
    assert not np.array_equal(s0["tokens"], s1["tokens"])
    with pytest.raises(AssertionError):
        tdata.SyntheticLM(cfg, 8, 7, seed=0, num_shards=2)


def test_prefetch_iterator_order():
    """The prefetching iterator yields the reference's batches in order from
    its start step."""
    cfg, tcfg = rreduced(rget("qwen2-vl-2b")), reduced_config(get_config("qwen2-vl-2b"))
    it = tdata.make_data_iterator(tcfg, 8, 4, seed=5, start_step=3, prefetch=2)
    ref = rdata.SyntheticLM(cfg, 8, 4, seed=5)
    for step in range(3, 9):
        _equal(next(it), ref.batch_at(step))


def test_prefetch_iterator_ends_with_its_source():
    it = tdata.PrefetchIterator(iter([1, 2, 3]), prefetch=1)
    assert list(it) == [1, 2, 3]
