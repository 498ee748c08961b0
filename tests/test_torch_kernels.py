"""``repro_torch.kernels`` against ``repro.kernels`` on the same numpy inputs.

On the CPU every wrapper of the port runs its plain version; the JAX
package runs its Pallas kernels in interpret mode, as tests/test_kernels.py
does.  The cases mirror that file's sweeps and tolerances (f32 2e-5 and
2e-4 for attention, bf16 3e-2 and 5e-2), and the gate's indices must be
equal.  The rest pins the port's own contract: shapes, block sizes and
devices it refuses, launch counting, and how its CUDA sources are keyed.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import cuda_build
from repro_torch.kernels import cuda, ops

REPO = Path(__file__).resolve().parents[1]
F32, BF16 = ("float32", jnp.float32, torch.float32), ("bfloat16", jnp.bfloat16, torch.bfloat16)
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
ATTN_TOL = {"float32": 2e-4, "bfloat16": 5e-2}


def _both(rng, shape, dtype=F32):
    """The same seeded values as a jax array and a CPU tensor of one dtype."""
    x = rng.randn(*shape).astype(np.float32)
    return jnp.asarray(x, dtype[1]), torch.tensor(x).to(dtype[2])


def _close(port, ref, tol):
    np.testing.assert_allclose(
        port.double().numpy(), np.asarray(ref, np.float64), rtol=tol, atol=tol
    )


# ------------------------------------------------------------------ softmax
@pytest.mark.parametrize("shape", [(8, 16), (4, 8, 32), (2, 3, 5, 64), (16, 128)])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=lambda d: d[0])
def test_softmax_matches_reference(rng, shape, dtype):
    jx, tx = _both(rng, shape, dtype)
    got = ops.softmax(tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, jops.softmax(jx), TOL[dtype[0]])


@pytest.mark.parametrize("block_rows", [1, 2, 4, 8])
def test_softmax_block_rows_match_reference(rng, block_rows):
    jx, tx = _both(rng, (8, 24))
    _close(ops.softmax(tx, block_rows=block_rows), jops.softmax(jx, block_rows=block_rows), TOL["float32"])


# ------------------------------------------------------------------ rmsnorm
@pytest.mark.parametrize("shape", [(4, 32), (2, 8, 64), (3, 5, 128)])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=lambda d: d[0])
def test_rmsnorm_matches_reference(rng, shape, dtype):
    jx, tx = _both(rng, shape, dtype)
    jg, tg = _both(rng, shape[-1:], dtype)
    got = ops.rmsnorm(tx, tg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, jops.rmsnorm(jx, jg), TOL[dtype[0]])


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(1, 2, 2, 16, 8), (2, 4, 2, 32, 16), (1, 8, 1, 16, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference(rng, B, Hq, Hkv, S, D, causal):
    jq, tq = _both(rng, (B, Hq, S, D))
    jk, tk = _both(rng, (B, Hkv, S, D))
    jv, tv = _both(rng, (B, Hkv, S, D))
    got = ops.attention(tq, tk, tv, causal=causal, block_q=8, block_k=8)
    _close(got, jops.attention(jq, jk, jv, causal=causal, block_q=8, block_k=8), ATTN_TOL["float32"])


def test_flash_attention_bf16_matches_reference(rng):
    (jq, tq), (jk, tk), (jv, tv) = (_both(rng, (1, 2, 16, 8), BF16) for _ in range(3))
    got = ops.attention(tq, tk, tv, causal=True, block_q=8, block_k=8)
    assert got.dtype == torch.bfloat16
    _close(got, jops.attention(jq, jk, jv, causal=True, block_q=8, block_k=8), ATTN_TOL["bfloat16"])


@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(2, 4, 2, 32, 8), (1, 8, 1, 64, 16), (3, 2, 2, 16, 8)])
def test_decode_attention_matches_reference(rng, B, Hq, Hkv, S, D):
    jq, tq = _both(rng, (B, Hq, D))
    jk, tk = _both(rng, (B, Hkv, S, D))
    jv, tv = _both(rng, (B, Hkv, S, D))
    lengths = rng.randint(1, S + 1, size=(B,)).astype(np.int32)
    got = ops.attention_decode(tq, tk, tv, torch.tensor(lengths), block_k=8)
    want = jops.attention_decode(jq, jk, jv, jnp.asarray(lengths), block_k=8)
    _close(got, want, ATTN_TOL["float32"])


def test_decode_matches_prefill_last_token(rng):
    """Pins the plain versions only: on CPU tensors both wrappers run
    ``kernels/ref.py``.  The kernels are held against those plain versions
    on the card by ``chip_smoke.py`` phase 6."""
    B, H, S, D = 1, 2, 16, 8
    q, k, v = (torch.tensor(rng.randn(B, H, S, D).astype(np.float32)) for _ in range(3))
    full = ops.attention(q, k, v, causal=True, block_q=8, block_k=8)
    dec = ops.attention_decode(q[:, :, -1].contiguous(), k, v, torch.full((B,), S, dtype=torch.int32),
                               block_k=8)
    torch.testing.assert_close(full[:, :, -1], dec, rtol=2e-4, atol=2e-4)


def test_zero_length_gives_nan_in_both_packages(rng):
    jq, tq = _both(rng, (2, 2, 8))
    jk, tk = _both(rng, (2, 1, 16, 8))
    jv, tv = _both(rng, (2, 1, 16, 8))
    lengths = np.array([0, 16], np.int32)
    got = ops.attention_decode(tq, tk, tv, torch.tensor(lengths), block_k=8)
    want = np.asarray(jops.attention_decode(jq, jk, jv, jnp.asarray(lengths), block_k=8))
    assert np.isnan(want[0]).all() and bool(got[0].isnan().all())
    _close(got[1], want[1], ATTN_TOL["float32"])


@pytest.mark.parametrize("op", ["flash", "decode", "softmax", "rmsnorm"])
def test_block_sizes_do_not_change_results(rng, op):
    """Pins the plain versions and the wrappers' block checks only: on CPU
    tensors every wrapper accepts these block sizes and then runs the same
    ``kernels/ref.py`` function.  Block sizes on the kernels themselves are
    checked on the card by ``chip_smoke.py`` phase 6's small sweep."""
    if op == "flash":
        q, k, v = (torch.tensor(rng.randn(1, 2, 32, 8).astype(np.float32)) for _ in range(3))
        a = ops.attention(q, k, v, block_q=8, block_k=16)
        b = ops.attention(q, k, v, block_q=32, block_k=32)
    elif op == "decode":
        q = torch.tensor(rng.randn(2, 4, 16).astype(np.float32))
        k, v = (torch.tensor(rng.randn(2, 2, 64, 16).astype(np.float32)) for _ in range(2))
        lengths = torch.tensor([37, 64], dtype=torch.int32)
        a = ops.attention_decode(q, k, v, lengths, block_k=8)
        b = ops.attention_decode(q, k, v, lengths)
    else:
        x = torch.tensor(rng.randn(8, 24).astype(np.float32))
        g = torch.tensor(rng.randn(24).astype(np.float32))
        call = ops.softmax if op == "softmax" else (lambda t, **kw: ops.rmsnorm(t, g, **kw))
        a, b = call(x, block_rows=1), call(x, block_rows=8)
    torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------- moe gate
@pytest.mark.parametrize("T,E,k", [(16, 8, 2), (32, 40, 8), (8, 16, 1), (64, 64, 4)])
def test_moe_gate_matches_reference(rng, T, E, k):
    jl, tl = _both(rng, (T, E))
    w, i = ops.moe_gate(tl, top_k=k, block_tokens=8)
    jw, ji = jops.moe_gate(jl, top_k=k, block_tokens=8)
    assert w.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    _close(w, jw, TOL["float32"])
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_moe_gate_bf16_logits_match_reference(rng):
    jl, tl = _both(rng, (16, 8), BF16)
    w, i = ops.moe_gate(tl, top_k=2, block_tokens=8)
    jw, ji = jops.moe_gate(jl.astype(jnp.float32), top_k=2, block_tokens=8)
    assert w.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    _close(w, jw, 2e-5)


def test_moe_gate_ties_go_to_the_lower_index():
    w, i = ops.moe_gate(torch.zeros(4, 8), top_k=3)
    assert i.tolist() == [[0, 1, 2]] * 4
    torch.testing.assert_close(w, torch.full((4, 3), 1 / 3))


# ------------------------------------------------------- the port's contract
def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("call, match", [
    (lambda: ops.softmax(_t(6, 8), block_rows=4), "rows 6 % block_rows 4"),
    (lambda: ops.softmax(_t(6, 8), block_rows=3), "block_rows 3"),
    (lambda: ops.rmsnorm(_t(4, 8), _t(6)), "gamma"),
    (lambda: ops.attention(_t(1, 2, 24, 8), _t(1, 2, 24, 8), _t(1, 2, 24, 8), block_q=16), "multiple"),
    (lambda: ops.attention(_t(1, 3, 16, 8), _t(1, 2, 16, 8), _t(1, 2, 16, 8)), "kv heads"),
    (lambda: ops.attention_decode(_t(1, 3, 8), _t(1, 2, 16, 8), _t(1, 2, 16, 8),
                                  _t(1, dtype=torch.int32)), "kv heads"),
    (lambda: ops.attention_decode(_t(1, 2, 8), _t(1, 2, 24, 8), _t(1, 2, 24, 8),
                                  _t(1, dtype=torch.int32), block_k=16), "multiple"),
    (lambda: ops.attention(_t(1, 2, 16, 12), _t(1, 2, 16, 12), _t(1, 2, 16, 12)), "head dim"),
    (lambda: ops.moe_gate(_t(4, 8), top_k=9), "top_k"),
    (lambda: ops.softmax(_t(4, 8, dtype=torch.float64)), "float64"),
    (lambda: ops.softmax(_t(8, 4).t()), "contiguous"),
])
def test_what_the_kernels_do_not_take_raises_value_error(call, match):
    with pytest.raises(ValueError, match=match):
        call()


_META_CALLS = {
    "softmax": lambda t: ops.softmax(t(4, 8)),
    "rmsnorm": lambda t: ops.rmsnorm(t(4, 8), t(8)),
    "attention": lambda t: ops.attention(t(1, 2, 16, 8), t(1, 2, 16, 8), t(1, 2, 16, 8)),
    "attention_decode": lambda t: ops.attention_decode(
        t(1, 2, 8), t(1, 2, 16, 8), t(1, 2, 16, 8), t(1, dtype=torch.int32)),
    "moe_gate": lambda t: ops.moe_gate(t(4, 8), top_k=2),
}


@pytest.mark.parametrize("op", sorted(_META_CALLS))
def test_meta_tensors_are_refused(op):
    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match="meta"):
        _META_CALLS[op](meta)


def test_a_cpu_call_counts_no_launch():
    before = {name: k.launches for name, k in ops.KERNELS.items()}
    for call in _META_CALLS.values():
        call(_t)
    assert {name: k.launches for name, k in ops.KERNELS.items()} == before
    assert sorted(ops.KERNELS) == sorted([
        "stitched_rmsnorm", "stitched_softmax", "stitched_flash_attention",
        "stitched_decode_attention", "stitched_moe_gate",
    ])


@pytest.mark.parametrize("name", sorted(ops.KERNELS))
def test_launching_with_no_loaded_library_raises(monkeypatch, name):
    kernel = ops.KERNELS[name]
    monkeypatch.setattr(kernel.source, "lib", None)
    before = kernel.launches
    with pytest.raises(RuntimeError, match="no CUDA library"):
        kernel.launch("sx_any", _t(4), 4, device=torch.device("cpu"))
    assert kernel.launches == before


@pytest.mark.parametrize("name", sorted(ops.KERNELS))
def test_each_kernel_names_the_tpu_kernel_it_replaces(name):
    kernel = ops.KERNELS[name]
    path, line = kernel.replaces.rsplit(":", 1)
    assert "pl.pallas_call(" in (REPO / path).read_text().splitlines()[int(line) - 1]
    source = kernel.source.path.read_text()
    assert f"{name} replaces {path.removeprefix('src/')}" in source
    assert 'extern "C" int sx_' in source


def test_cuda_build_keys_every_included_header(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("// v1\n")
    (tmp_path / "k.cu").write_text('#include "outer.cuh"\n#include <cuda_runtime.h>\n')
    src = (tmp_path / "k.cu").read_text()
    assert cuda_build.included_headers(src) == [tmp_path / "outer.cuh", tmp_path / "inner.cuh"]
    before = cuda_build.library_path(src)
    assert before == cuda_build.library_path(src)
    (tmp_path / "inner.cuh").write_text("// v2\n")
    assert cuda_build.library_path(src) != before


def test_hand_written_sources_include_the_shared_headers():
    for source in cuda.SOURCES:
        names = [h.name for h in cuda_build.included_headers(source.path.read_text())]
        assert names == ["hand_kernels.cuh", "stitch_runtime.cuh"]
        launchers = re.findall(r'extern "C" int (\w+)\(', source.path.read_text())
        assert launchers and all(n.endswith(("_f32", "_bf16")) for n in launchers)
