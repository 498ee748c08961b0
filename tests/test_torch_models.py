"""The port's configs and models (``repro_torch.configs``,
``repro_torch.models``) against the reference's, on the CPU.

* Configs: every field of the ten architectures, ``reduced_config`` and
  ``SHAPES`` equal the reference's.
* ``param_specs``: keys, shapes, dtypes, ``count_params`` and
  ``tree_bytes`` equal the reference's, at ``reduced_config`` and at full
  size (on the meta device, no memory).
* ``forward``: the reference's weights (``repro.models.init_params``)
  carried across by ``params_from_reference``, the same batch, logits
  held at ``F32_TOL`` in float32 and ``BF16_ATOL`` in bfloat16.
* The layer functions one by one on seeded numpy inputs, ``moe_scatter``
  at a capacity that drops tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import models as rmodels
from repro.data import SyntheticLM
from repro.models import layers as rL
from repro.models import ssm as rS
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.models import layers as tL
from repro_torch.models import ssm as tS

ALL_ARCHS = sorted(rconfigs.ARCHITECTURES)
#: float32 logits and layer outputs: rtol = atol (measured: 4.5e-6 at |logits| ~4)
F32_TOL = 2e-5
#: bfloat16 logits: 4 bf16 ulps at |logits| ~4 (measured: up to 2 ulps; XLA on
#: the CPU may keep excess precision between bf16 ops where torch rounds each)
BF16_ATOL = 0.125


def _cfgs(arch, **kw):
    return (rconfigs.reduced_config(rconfigs.get_config(arch), **kw),
            tconfigs.reduced_config(tconfigs.get_config(arch), **kw))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=F32_TOL):
    got = got.detach().to(torch.float32).numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


def _dtype_name(d):
    return str(d).split(".")[-1] if isinstance(d, torch.dtype) else np.dtype(d).name


def _spec_table(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_table(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), _dtype_name(tree.dtype))}


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_equal_the_reference(arch):
    ref, port = rconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.padded_vocab == ref.padded_vocab
    assert port.param_count_estimate() == ref.param_count_estimate()
    assert port.active_param_count_estimate() == ref.active_param_count_estimate()
    assert port.torch_dtype == torch.bfloat16
    r_small, t_small = _cfgs(arch)
    assert dataclasses.asdict(t_small) == dataclasses.asdict(r_small)
    assert t_small.torch_dtype == torch.float32


def test_registry_and_shapes_equal_the_reference():
    assert sorted(tconfigs.ARCHITECTURES) == ALL_ARCHS
    assert tconfigs.SHAPES == rconfigs.SHAPES
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-2")
    with pytest.raises(ValueError, match="unknown dtype"):
        dataclasses.replace(tconfigs.get_config("granite-20b"), dtype="float8").torch_dtype


# -------------------------------------------------------------- param specs
@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("size", ["reduced", "full"])
def test_param_specs_equal_the_reference(arch, size):
    if size == "reduced":
        rcfg, tcfg = _cfgs(arch)
    else:
        rcfg, tcfg = rconfigs.get_config(arch), tconfigs.get_config(arch)
    ref = rmodels.param_specs(rcfg)
    port = tmodels.param_specs(tcfg)
    assert _spec_table(port) == _spec_table(ref)
    assert all(t.device.type == "meta" for t in tmodels.module.tree_leaves(port))
    assert tmodels.count_params(port) == rmodels.count_params(ref)
    assert tmodels.tree_bytes(port) == rmodels.tree_bytes(ref)


def test_init_params_is_seeded_and_matches_its_specs():
    _, cfg = _cfgs("hymba-1.5b")
    a = tmodels.init_params(cfg, 3, device="cpu")
    b = tmodels.init_params(cfg, 3, device="cpu")
    c = tmodels.init_params(cfg, 4, device="cpu")
    assert _spec_table(a) == _spec_table(tmodels.param_specs(cfg))
    leaves = list(zip(tmodels.module.tree_leaves(a), tmodels.module.tree_leaves(b),
                      tmodels.module.tree_leaves(c)))
    assert all(torch.equal(x, y) for x, y, _ in leaves)
    assert any(not torch.equal(x, z) for x, _, z in leaves)
    # each stacked layer is drawn on its own
    wq = a["layers"]["attn"]["wq"]["w"]
    assert not torch.equal(wq[0], wq[1])
    assert torch.equal(a["layers"]["ln1"]["gamma"], torch.ones_like(a["layers"]["ln1"]["gamma"]))


def test_params_from_reference_carries_bf16_exactly():
    rcfg, _ = _cfgs("granite-moe-3b-a800m", dtype="bfloat16")
    ref = jax.tree.map(np.asarray, rmodels.init_params(rcfg, 0))
    port = tmodels.params_from_reference(ref, device="cpu")
    w = port["layers"]["moe"]["wi"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.float().numpy(), ref["layers"]["moe"]["wi"].astype(np.float32))
    assert port["layers"]["moe"]["router"].dtype == torch.float32


# ------------------------------------------------------------------ forward
def _batch(cfg, B=2, S=16):
    return SyntheticLM(cfg, S, B, seed=0).batch_at(0)


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_the_reference(arch, dtype):
    rcfg, tcfg = _cfgs(arch, dtype=dtype)
    rparams = rmodels.init_params(rcfg, 0)
    tparams = tmodels.params_from_reference(jax.tree.map(np.asarray, rparams), device="cpu")
    batch = _batch(rcfg)
    want = np.asarray(rmodels.forward(rparams, {k: jnp.asarray(v) for k, v in batch.items()}, rcfg))
    got = tmodels.forward(tparams, batch, tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if dtype == "float32":
        _close(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_ATOL)


def test_forward_return_hidden_and_moe_scatter_match_the_reference():
    rcfg, tcfg = _cfgs("granite-moe-3b-a800m", moe_impl="scatter", moe_capacity_factor=0.5)
    rparams = rmodels.init_params(rcfg, 1)
    tparams = tmodels.params_from_reference(jax.tree.map(np.asarray, rparams), device="cpu")
    batch = _batch(rcfg, B=2, S=64)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    _close(tmodels.forward(tparams, batch, tcfg),
           rmodels.forward(rparams, rb, rcfg))
    _close(tmodels.forward(tparams, batch, tcfg, return_hidden=True),
           rmodels.forward(rparams, rb, rcfg, return_hidden=True))


def test_sequence_parallel_activations_raise_naming_the_sharding_item():
    """Kept under its old name: ``activation_sharding="sp"`` no longer
    raises; its forward equals ``"none"`` bit for bit (outside a mesh the
    hooks change nothing; ``tests/test_torch_sp.py`` holds them inside)."""
    _, tcfg = _cfgs("qwen2.5-14b", activation_sharding="sp")
    params = tmodels.init_params(tcfg, 0, device="cpu")
    batch = _batch(tcfg)
    none = dataclasses.replace(tcfg, activation_sharding="none")
    assert torch.equal(tmodels.forward(params, batch, tcfg), tmodels.forward(params, batch, none))


# ----------------------------------------------------------- layer functions
def test_norms_match_the_reference():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 48) * 3 + 1).astype(np.float32)
    g = rng.randn(48).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    _close(tL.layernorm({"gamma": _t(g), "beta": _t(b)}, _t(x), 1e-6),
           rL.layernorm({"gamma": g, "beta": b}, jnp.asarray(x), 1e-6))
    _close(tL.rmsnorm({"gamma": _t(g)}, _t(x), 1e-6), rL.rmsnorm({"gamma": g}, jnp.asarray(x), 1e-6))


def test_mlps_and_linear_bias_match_the_reference():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 32).astype(np.float32)
    p = {"wi": {"w": rng.randn(32, 64).astype(np.float32) * 0.2, "b": rng.randn(64).astype(np.float32)},
         "wo": {"w": rng.randn(64, 32).astype(np.float32) * 0.2, "b": rng.randn(32).astype(np.float32)}}
    tp = {k: {n: _t(a) for n, a in v.items()} for k, v in p.items()}
    _close(tL.gelu_mlp(tp, _t(x)), rL.gelu_mlp(p, jnp.asarray(x)))
    sw = {k: {"w": rng.randn(*s).astype(np.float32) * 0.2}
          for k, s in (("wi", (32, 64)), ("wg", (32, 64)), ("wo", (64, 32)))}
    _close(tL.swiglu({k: {"w": _t(v["w"])} for k, v in sw.items()}, _t(x)),
           rL.swiglu(sw, jnp.asarray(x)))


def test_rotary_embeddings_match_the_reference():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 3, 16).astype(np.float32)
    pos = (rng.randint(0, 5000, (2, 9))).astype(np.int32)
    _close(tL.rope(_t(x), _t(pos), 1e6), rL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-4)
    pos3 = rng.randint(0, 300, (3, 2, 9)).astype(np.int32)
    _close(tL.mrope(_t(x), _t(pos3), (2, 3, 3), 1e4),
           rL.mrope(jnp.asarray(x), jnp.asarray(pos3), (2, 3, 3), 1e4), 1e-4)
    _close(tL.sinusoidal_positions(12, 32, offset=3), rL.sinusoidal_positions(12, 32, offset=3))


@pytest.mark.parametrize("causal,window,q_offset,chunks", [
    (True, 0, 0, (8, 8)),
    (True, 5, 0, (4, 8)),        # sliding window: chunks masked whole
    (True, 6, 8, (8, 4)),        # a q_offset past the keys' start
    (False, 0, 0, (16, 16)),
    (True, 3, 0, (7, 5)),        # chunk sizes that do not divide: they shrink
])
def test_online_attention_matches_the_reference(causal, window, q_offset, chunks):
    rng = np.random.RandomState(3)
    Sq = 16
    Sk = Sq + q_offset
    q = rng.randn(2, Sq, 6, 8).astype(np.float32)
    k = rng.randn(2, Sk, 2, 8).astype(np.float32)
    v = rng.randn(2, Sk, 2, 8).astype(np.float32)
    kw = dict(causal=causal, q_chunk=chunks[0], kv_chunk=chunks[1],
              sliding_window=window, q_offset=q_offset)
    _close(tL.online_attention(_t(q), _t(k), _t(v), **kw),
           rL.online_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))


def test_decode_attention_and_int8_quantization_match_the_reference():
    rng = np.random.RandomState(4)
    q = rng.randn(3, 6, 8).astype(np.float32)
    kc = rng.randn(3, 10, 2, 8).astype(np.float32)
    vc = rng.randn(3, 10, 2, 8).astype(np.float32)
    length = np.array([1, 7, 10], np.int32)
    _close(tL.decode_attention(_t(q), _t(kc), _t(vc), _t(length)),
           rL.decode_attention_jnp(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(length)))
    x = rng.randn(3, 2, 8).astype(np.float32)
    x[0, 0, :4] = [0.5, -0.5, 1.5, 127.0]        # halves: round half to even
    q8, s = tL.quantize_kv_int8(_t(x))
    r8, rs = rL.quantize_kv_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(r8))
    _close(s, rs, 0)
    k8 = rng.randint(-127, 128, (3, 10, 2, 8)).astype(np.int8)
    v8 = rng.randint(-127, 128, (3, 10, 2, 8)).astype(np.int8)
    ks = rng.rand(3, 10, 2).astype(np.float32) * 0.02
    vs = rng.rand(3, 10, 2).astype(np.float32) * 0.02
    _close(tL.decode_attention(_t(q), _t(k8), _t(v8), _t(length), _t(ks), _t(vs)),
           rL.decode_attention_jnp(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
                                   jnp.asarray(length), jnp.asarray(ks), jnp.asarray(vs)))


def test_ssm_pieces_match_the_reference():
    rng = np.random.RandomState(5)
    b, S, H, P, N = 2, 24, 3, 4, 5
    x = rng.randn(b, S, H, P).astype(np.float32)
    dt = rng.rand(b, S, H).astype(np.float32) * 0.5
    A_log = rng.randn(H).astype(np.float32) * 0.3
    Bm = rng.randn(b, S, N).astype(np.float32)
    Cm = rng.randn(b, S, N).astype(np.float32)
    D = rng.randn(H).astype(np.float32)
    for chunk in (8, 7, 128):
        y, st = tS.ssd_chunked(_t(x), _t(dt), _t(A_log), _t(Bm), _t(Cm), _t(D), chunk)
        ry, rst = rS.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A_log, Bm, Cm, D)), chunk)
        _close(y, ry, 1e-4)
        _close(st, rst, 1e-4)
    seg = tS._segsum(_t(dt * -1.0))
    rseg = np.asarray(rS._segsum(jnp.asarray(dt * -1.0)))
    assert torch.equal(torch.isinf(seg), torch.from_numpy(np.isinf(rseg)))
    _close(torch.where(torch.isinf(seg), 0.0, seg), np.where(np.isinf(rseg), 0.0, rseg))
    xs = rng.randn(b, S, 7).astype(np.float32)
    w = rng.randn(4, 7).astype(np.float32)
    cb = rng.randn(7).astype(np.float32)
    _close(tS._causal_conv(_t(xs), _t(w), _t(cb)), rS._causal_conv(jnp.asarray(xs), w, cb))


def _moe_params(rng, d, ff, E):
    return {"router": rng.randn(d, E).astype(np.float32) * 0.5,
            "wi": rng.randn(E, d, ff).astype(np.float32) * 0.2,
            "wg": rng.randn(E, d, ff).astype(np.float32) * 0.2,
            "wo": rng.randn(E, ff, d).astype(np.float32) * 0.2}


@pytest.mark.parametrize("factor", [0.25, 1.25, 8.0])
def test_moe_scatter_matches_the_reference(factor):
    """At factor 0.25 a group of 128 tokens sends 256 top-2 routes to 4
    experts of C = 64 slots: wherever routing is uneven, tokens drop, and
    they must drop as the reference's do."""
    rcfg, tcfg = _cfgs("granite-moe-3b-a800m", moe_capacity_factor=factor,
                       moe_experts=4, moe_top_k=2)
    rng = np.random.RandomState(6)
    p = _moe_params(rng, 16, 24, 4)
    x = rng.randn(2, 128, 16).astype(np.float32)
    tp = {k: _t(v) for k, v in p.items()}
    assert tL.moe_capacity(tcfg, 128) == {0.25: 64, 1.25: 128, 8.0: 512}[factor]
    got = tL.moe_scatter(tp, _t(x), tcfg)
    want = rL.moe_scatter(p, jnp.asarray(x), rcfg)
    _close(got, want)
    if factor == 0.25:
        dense = tL.moe_dense(tp, _t(x), tcfg)
        assert not torch.allclose(got, dense, atol=1e-3)      # drops happened
    else:
        _close(tL.moe_dense(tp, _t(x), tcfg), rL.moe_dense(p, jnp.asarray(x), rcfg))


def test_router_takes_ties_lowest_index_first():
    _, tcfg = _cfgs("granite-moe-3b-a800m", moe_experts=6, moe_top_k=3)
    rcfg, _ = _cfgs("granite-moe-3b-a800m", moe_experts=6, moe_top_k=3)
    router = np.zeros((4, 6), np.float32)           # every logit equal: all tie
    x = np.random.RandomState(7).randn(1, 5, 4).astype(np.float32)
    w, idx = tL._router({"router": _t(router)}, _t(x), tcfg)
    rw, ridx = rL._router({"router": router}, jnp.asarray(x), rcfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(idx.numpy()[0, 0], [0, 1, 2])
    _close(w, rw)
