"""The program through ``repro_torch.stitch`` on the CPU against the plain
reference, for each configuration, at small widths of its own shape."""
import pytest
import torch

from stitchbench import harness
from stitchbench_cells import CONFIGS, small_cell

#: ``out_err`` of a sound float32 program at these widths: the gap is the
#: rounding of the residual adds (an ulp of ``x``) over the stack's largest
#: change to ``x``, which is small at small widths
CPU_TOL = 2e-4
#: the same of a bfloat16 program: its residual stream is held in bfloat16,
#: so the gap is about an ulp of bfloat16 at ``x``'s largest values (2^-6
#: at 4) over the stack's change; the fp8 control reads ten times this
BF16_TOL = 0.5
F32 = sorted(c for c in CONFIGS if not c.endswith("-bf16"))


def _tol(cell):
    return CPU_TOL if cell.shape["dtype"] == "float32" else BF16_TOL


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_stitched_program_matches_reference(config):
    cell = small_cell(CONFIGS[config])
    inputs = cell.program.make_inputs(cell.config, cell.batch, cell.seq, 7, 2,
                                      torch.device("cpu"))
    sf = harness.compile_layer(cell, torch.device("cpu"))
    for i, x in enumerate(inputs[2]):
        assert harness.errors(cell, inputs, x, harness.request(sf, inputs, i))["out_err"] < _tol(cell)
    assert sf.num_fallbacks == 0


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_eager_program_matches_reference(config):
    cell = small_cell(CONFIGS[config])
    inputs = cell.program.make_inputs(cell.config, cell.batch, cell.seq, 7, 1,
                                      torch.device("cpu"))
    fn = cell.program.build(cell.config, cell.batch, cell.seq)
    y = harness.request(fn, inputs, 0)
    assert harness.errors(cell, inputs, inputs[2][0], y)["out_err"] < _tol(cell)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_bf16_control_fails_where_the_program_passes(config):
    """On the CPU TF32 does not exist, so only the fp8 control of a
    bfloat16 configuration can be read here."""
    cell = small_cell(CONFIGS[config])
    if cell.shape["dtype"] != "bfloat16":
        cell.config = dict(cell.config, dtype="bfloat16")
    [(_, prog, ctl)] = harness.control_readings(cell, [5], torch.device("cpu"))
    assert prog["out_err"] < BF16_TOL < ctl["out_err"]


def test_reference_is_causal_and_per_sequence():
    """A later token changes no earlier output, and sequences do not mix."""
    cell = small_cell(CONFIGS["mistral-large-123b.tp8"])
    layers, (cos, sin), xs = cell.program.make_inputs(cell.config, cell.batch, cell.seq, 7, 1,
                                                      torch.device("cpu"))
    x = xs[0].clone()

    def fwd(x):
        return cell.reference.forward(cell.config, cell.shape, cell.seq, layers, x, cos, sin)

    base = fwd(x)
    x[cell.seq - 1] += 1.0                        # the last token of sequence 0
    moved = fwd(x)
    assert torch.equal(base[:cell.seq - 1], moved[:cell.seq - 1])
    assert torch.equal(base[cell.seq:], moved[cell.seq:])
    assert not torch.equal(base[cell.seq - 1], moved[cell.seq - 1])


def test_each_layer_has_weights_of_its_own():
    cell = small_cell(CONFIGS["granite-moe-3b-a800m.attn"], layers=3)
    layers, _, _ = cell.program.make_inputs(cell.config, 1, 8, 7, 1, torch.device("cpu"))
    assert len(layers) == 3
    assert list(layers[0]) == list(cell.program.args(cell.config)[:-2])
    assert not torch.equal(layers[0]["wq"], layers[1]["wq"])


def test_a_chip_holds_its_share_of_each_layer():
    cell = small_cell(CONFIGS["mistral-large-123b.tp8"])
    s = cell.shape
    cfg = cell.config
    assert cfg["tensor_parallel"] == 8
    assert s["heads"] * 8 == cfg["num_attention_heads"]
    assert s["kv_heads"] * 8 == cfg["num_key_value_heads"]
    assert s["ff"] * 8 == cfg["intermediate_size"]
    layers, _, _ = cell.program.make_inputs(cfg, 1, 8, 7, 1, torch.device("cpu"))
    assert layers[0]["wq"].shape == (s["d"], s["heads"] * s["head_dim"])
    assert layers[0]["wd"].shape == (s["ff"], s["d"])


@pytest.mark.parametrize("config", F32)
def test_inputs_repeat_with_the_seed_and_take_a_large_one(config):
    cell = small_cell(CONFIGS[config])
    seed = 2**31 + 2**30 + 17
    a1, _, x1 = cell.program.make_inputs(cell.config, 1, 8, seed, 2, torch.device("cpu"))
    a2, _, x2 = cell.program.make_inputs(cell.config, 1, 8, seed, 2, torch.device("cpu"))
    a3, _, _ = cell.program.make_inputs(cell.config, 1, 8, seed + 1, 2, torch.device("cpu"))
    assert all(torch.equal(p[k], q[k]) for p, q in zip(a1, a2) for k in p)
    assert all(torch.equal(p, q) for p, q in zip(x1, x2))
    assert not torch.equal(a1[0]["wq"], a3[0]["wq"])
    assert not torch.equal(x1[0], x1[1])
