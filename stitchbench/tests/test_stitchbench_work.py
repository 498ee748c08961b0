"""``work.py``'s counts against the cells' numbers worked out by hand."""
import pytest

from stitchbench import harness, work
from stitchbench_cells import BENCH

#: GFLOP a request: (library products, attention as a dense kernel
#: computes it, attention as the causal outputs need it), tokens
EXPECTED = {
    # 8 layers of (4 x 4096, 1536) through q, k, v, o of 1536 + 512 + 512 + 1536
    "granite-moe-3b-a800m.attn.prefill-4k": (1649.3, 3298.5, 1649.7, 16384),
    "granite-moe-3b-a800m.attn-bf16.prefill-4k": (1649.3, 3298.5, 1649.7, 16384),
    # 88 layers of (2048, 12288) through 1536 + 128 + 128 + 1536 + 3 x 3584
    "mistral-large-123b.tp8.prefill-2k": (62362.9, 2267.7, 1134.4, 2048),
}


@pytest.mark.parametrize("workload", sorted(EXPECTED))
def test_counts_of_each_cell(workload):
    cell = harness.load_cell(workload, BENCH)
    w = cell.program.WORK(cell.config, cell.batch, cell.seq)
    gemm, dense, causal, tokens = EXPECTED[workload]
    assert round(w.gemm_flops / 1e9, 1) == gemm
    assert round(w.fused_flops_dense / 1e9, 1) == dense
    assert round(w.fused_flops / 1e9, 1) == causal
    assert w.tokens == tokens
    assert w.flops == w.gemm_flops + w.fused_flops
    assert w.peak_flops == work.PEAK_FLOPS[cell.config["dtype"]]


def test_causal_count_is_the_pairs_a_mask_keeps():
    b, h, t, d = 2, 3, 5, 4
    pairs = sum(i + 1 for i in range(t))
    assert work.causal_attention_flops(b, h, t, d) == 2 * 2 * d * pairs * b * h
    assert work.dense_attention_flops(b, h, t, d) == 2 * 2 * d * t * t * b * h


def _cfg(**kw):
    cfg = {"hidden_size": 8, "head_dim": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
           "num_hidden_layers": 3, "dtype": "float32"}
    cfg.update(kw)
    return cfg


def test_bytes_of_the_attention_sublayer_outside_its_products():
    w = work.decoder_stack(_cfg(), batch=3, seq=5)
    n = 15
    # a layer: x, g, cos, sin, q, k, v, o @ wo in; h, o, its output out; 4 bytes each
    assert w.fused_bytes == 3 * 4 * (n * 8 + 8 + 2 * 5 * 2 + n * 8 + 2 * n * 4 + n * 8
                                     + n * 8 + n * 8 + n * 8)
    assert w.gemm_bytes == 3 * 4 * ((n * 8 + 8 * 8 + n * 8) * 2 + (n * 8 + 8 * 4 + n * 4) * 2)


def test_a_tensor_parallel_share_and_its_mlp():
    full = work.decoder_stack(_cfg(intermediate_size=12, mlp="gated_silu"), batch=1, seq=5)
    share = work.decoder_stack(_cfg(intermediate_size=12, mlp="gated_silu", tensor_parallel=2,
                                    dtype="bfloat16"), batch=1, seq=5)
    # each product's width that the chips divide is halved: the flops halve
    assert share.gemm_flops == full.gemm_flops / 2
    assert share.fused_flops == full.fused_flops / 2
    assert share.peak_flops == work.PEAK_FLOPS["bfloat16"]
    n = 5
    # the MLP: 3 layers of (n, 8) through gate, up (6 wide each) and down
    mlp = 3 * (2 * 2 * n * 8 * 6 + 2 * n * 6 * 8)
    attn = 3 * (2 * n * 8 * (2 + 1 + 1) + 2 * n * 2 * 8) * 2   # heads 2 of 4, kv 1 of 2
    assert share.gemm_flops == mlp + attn


def test_roofline_takes_the_longer_bound():
    f = work.PEAK_FLOPS["float32"]
    assert work.seconds_at_roofline(f, 0.0, f) == pytest.approx(1.0)
    assert work.seconds_at_roofline(0.0, 3.35e12, f) == pytest.approx(1.0)
    assert work.seconds_at_roofline(f, 6.7e12, f) == pytest.approx(2.0)
