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
from repro_torch.kernels import (
    cuda, ops, stitched_attention, stitched_moe_gate, stitched_rmsnorm, stitched_softmax,
)

REPO = Path(__file__).resolve().parents[1]
F32, BF16 = ("float32", jnp.float32, torch.float32), ("bfloat16", jnp.bfloat16, torch.bfloat16)
F16 = ("float16", jnp.float16, torch.float16)
# f16 keeps 11 significant bits: its limits are bf16's over 8, two ulps
TOL = {"float32": 2e-5, "bfloat16": 3e-2, "float16": 4e-3}
ATTN_TOL = {"float32": 2e-4, "bfloat16": 5e-2, "float16": 8e-3}


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


def test_softmax_full_width_with_masked_slices_matches_reference(rng):
    """The sampler's rows at full width (16, 49155), where the card runs
    the cluster kernel: the first eighth of row 0 (one block's slice) at
    -inf, the second eighth of row 1, and rows that are NaN across (a NaN,
    a +inf, only -inf), against the Pallas kernel in interpret mode."""
    x = rng.randn(16, 49155).astype(np.float32)
    eighth = -(-49155 // stitched_softmax.CLUSTER_BLOCKS)
    x[0, :eighth] = -np.inf
    x[1, eighth:2 * eighth] = -np.inf
    x[3, 5], x[4, 7], x[5] = np.nan, np.inf, -np.inf
    got = ops.softmax(torch.tensor(x))
    want = np.asarray(jops.softmax(jnp.asarray(x)))
    assert np.isnan(want[3:6]).all() and not np.isnan(np.delete(want, [3, 4, 5], axis=0)).any()
    assert (want[0, :eighth] == 0).all() and (want[1, eighth:2 * eighth] == 0).all()
    np.testing.assert_array_equal(got.isnan().numpy(), np.isnan(want))
    _close(got, want, TOL["float32"])


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
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(1, 2, 2, 16, 8), (2, 4, 2, 32, 16), (1, 8, 1, 16, 8),
                                         (1, 8, 1, 48, 8), (1, 8, 1, 80, 16)])
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


# S = 48 and 80 are not multiples of the bf16 kernel's 64-row tiles
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(1, 8, 1, 48, 16), (1, 8, 1, 80, 64), (1, 3, 1, 48, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_edges_match_reference(rng, B, Hq, Hkv, S, D, causal):
    jq, tq = _both(rng, (B, Hq, S, D), BF16)
    jk, tk = _both(rng, (B, Hkv, S, D), BF16)
    jv, tv = _both(rng, (B, Hkv, S, D), BF16)
    got = ops.attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    _close(got, jops.attention(jq, jk, jv, causal=causal), ATTN_TOL["bfloat16"])


@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(2, 4, 2, 32, 8), (1, 8, 1, 64, 16), (3, 2, 2, 16, 8)])
def test_decode_attention_matches_reference(rng, B, Hq, Hkv, S, D):
    jq, tq = _both(rng, (B, Hq, D))
    jk, tk = _both(rng, (B, Hkv, S, D))
    jv, tv = _both(rng, (B, Hkv, S, D))
    lengths = rng.randint(1, S + 1, size=(B,)).astype(np.int32)
    got = ops.attention_decode(tq, tk, tv, torch.tensor(lengths), block_k=8)
    want = jops.attention_decode(jq, jk, jv, jnp.asarray(lengths), block_k=8)
    _close(got, want, ATTN_TOL["float32"])


# lengths at the edges of the kernel's splits: 0 (NaN in both), 1, split - 1,
# split, split + 1 and S, at G = 1, 3 and 8
@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=lambda d: d[0])
def test_decode_attention_split_edges_match_reference(rng, G, dtype):
    S, D = 512, 16
    split = stitched_attention.decode_splits(S)[0]
    lengths = np.array([0, 1, split - 1, split, split + 1, S], np.int32)
    B = len(lengths)
    jq, tq = _both(rng, (B, 2 * G, D), dtype)
    jk, tk = _both(rng, (B, 2, S, D), dtype)
    jv, tv = _both(rng, (B, 2, S, D), dtype)
    got = ops.attention_decode(tq, tk, tv, torch.tensor(lengths))
    want = jops.attention_decode(jq, jk, jv, jnp.asarray(lengths))
    assert bool(got[0].isnan().all()) and np.isnan(np.asarray(want[0], np.float32)).all()
    _close(got, want, ATTN_TOL[dtype[0]])


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


@pytest.mark.parametrize("E", [8, 40])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=lambda d: d[0])
def test_moe_gate_nan_and_inf_rows_match_reference(rng, E, k, dtype):
    """Rows with a NaN logit, a +inf logit, only -inf logits (each NaN
    across the row after the softmax) and one -inf among finite logits,
    beside finite rows.  The Pallas kernel picks the lowest NaN index
    again and again (NaN - 2.0 is NaN); the port's indices must be the
    same, with NaN weights exactly where the reference has them."""
    x = rng.randn(8, E).astype(np.float32)
    x[1, 3] = np.nan
    x[3, E - 1] = np.inf
    x[5] = -np.inf
    x[6, 2] = -np.inf
    tl = torch.tensor(x).to(dtype[2])
    w, i = ops.moe_gate(tl, top_k=k)
    jw, ji = jops.moe_gate(jnp.asarray(tl.float().numpy()), top_k=k)
    jw = np.asarray(jw)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert i[[1, 3, 5]].tolist() == [[0] * k] * 3
    np.testing.assert_array_equal(w.isnan().numpy(), np.isnan(jw))
    assert np.isnan(jw[[1, 3, 5]]).all() and not np.isnan(jw[[0, 2, 4, 6, 7]]).any()
    _close(w, jw, TOL["float32"])


# ---------------------------------------------------------------- float16
# The five kernels in f16 against the Pallas kernels in f16 (interpret mode).
@pytest.mark.parametrize("shape", [(8, 16), (2, 3, 64)])
def test_softmax_f16_matches_reference(rng, shape):
    jx, tx = _both(rng, shape, F16)
    got = ops.softmax(tx)
    assert got.dtype == torch.float16
    _close(got, jops.softmax(jx), TOL["float16"])


@pytest.mark.parametrize("shape", [(4, 32), (3, 5, 128)])
def test_rmsnorm_f16_matches_reference(rng, shape):
    jx, tx = _both(rng, shape, F16)
    jg, tg = _both(rng, shape[-1:], F16)
    got = ops.rmsnorm(tx, tg)
    assert got.dtype == torch.float16
    _close(got, jops.rmsnorm(jx, jg), TOL["float16"])


@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(1, 2, 2, 16, 8), (1, 4, 2, 48, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_f16_matches_reference(rng, B, Hq, Hkv, S, D, causal):
    jq, tq = _both(rng, (B, Hq, S, D), F16)
    jk, tk = _both(rng, (B, Hkv, S, D), F16)
    jv, tv = _both(rng, (B, Hkv, S, D), F16)
    got = ops.attention(tq, tk, tv, causal=causal, block_q=8, block_k=8)
    assert got.dtype == torch.float16
    _close(got, jops.attention(jq, jk, jv, causal=causal, block_q=8, block_k=8),
           ATTN_TOL["float16"])


def test_decode_attention_f16_matches_reference(rng):
    jq, tq = _both(rng, (2, 4, 16), F16)
    jk, tk = _both(rng, (2, 2, 32, 16), F16)
    jv, tv = _both(rng, (2, 2, 32, 16), F16)
    lengths = np.array([5, 32], np.int32)
    got = ops.attention_decode(tq, tk, tv, torch.tensor(lengths), block_k=8)
    assert got.dtype == torch.float16
    want = jops.attention_decode(jq, jk, jv, jnp.asarray(lengths), block_k=8)
    _close(got, want, ATTN_TOL["float16"])


def test_moe_gate_f16_logits_match_reference(rng):
    jl, tl = _both(rng, (16, 40), F16)
    w, i = ops.moe_gate(tl, top_k=4, block_tokens=8)
    jw, ji = jops.moe_gate(jl, top_k=4, block_tokens=8)
    assert w.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    _close(w, jw, TOL["float16"])


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
        assert launchers and all(n.endswith(("_f32", "_bf16", "_f16")) for n in launchers)
        # every launcher of a 2-byte type has its twin in the other one
        assert {n[:-5] for n in launchers if n.endswith("_bf16")} == {
            n[:-4] for n in launchers if n.endswith("_f16")}


# ---------------------------------------------------- the wrappers' launch plans
class _RecordingLibrary:
    """Stands in for a loaded CUDA library: each launcher records its name
    and the C values it was called with, and returns cudaSuccess."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, symbol):
        calls = self.calls

        def launcher(*values):
            calls.append((symbol, values))
            return 0

        return launcher


@pytest.fixture
def recorded(monkeypatch):
    """The attention, gate, RMSNorm and softmax wrappers as they run on the card,
    with their launches recorded instead of made: the library is a ``_RecordingLibrary`` and
    the inputs count as CUDA tensors."""
    lib = _RecordingLibrary()
    for source in (cuda.ATTENTION, cuda.ROWWISE):
        monkeypatch.setattr(source, "lib", lib)
    for module in (stitched_attention, stitched_moe_gate, stitched_rmsnorm, stitched_softmax):
        monkeypatch.setattr(module, "input_device", lambda name, ts: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0})())
    return lib


@pytest.mark.parametrize("dtype, symbol", [
    (torch.bfloat16, "sx_flash_mma_attention_bf16"),
    (torch.float16, "sx_flash_mma_attention_f16"),
    (torch.float32, "sx_flash_attention_f32"),
])
def test_flash_launches_the_tensor_core_kernel_in_bf16_only(recorded, dtype, symbol):
    """bf16 and f16 take the tensor-core kernel, f32 the CUDA cores'."""
    q, k, v = _t(1, 6, 80, 64, dtype=dtype), _t(1, 2, 80, 64, dtype=dtype), _t(1, 2, 80, 64, dtype=dtype)
    before = ops.KERNELS["stitched_flash_attention"].launches
    ops.attention(q, k, v, causal=True)
    assert [c[0] for c in recorded.calls] == [symbol]
    assert ops.KERNELS["stitched_flash_attention"].launches == before + 1
    values = recorded.calls[0][1]
    # q, k, v, o, then B, Hq, Hkv, S, D; the current stream comes last
    assert values[:3] == tuple(t.data_ptr() for t in (q, k, v))
    assert values[4:9] == (1, 6, 2, 80, 64) and values[-1] == 0


@pytest.mark.parametrize("op", ["flash", "decode"])
def test_misaligned_rows_are_refused_before_a_launch(recorded, op):
    """The attention kernels read rows with 16-byte loads: a contiguous view
    that starts 2 bytes into its storage is refused, not launched."""
    def at_offset(*shape):
        return torch.zeros(int(np.prod(shape)) + 1, dtype=torch.bfloat16)[1:].view(*shape)

    if op == "flash":
        call = lambda: ops.attention(_t(1, 2, 16, 8, dtype=torch.bfloat16), at_offset(1, 2, 16, 8),
                                     _t(1, 2, 16, 8, dtype=torch.bfloat16))
    else:
        call = lambda: ops.attention_decode(_t(1, 2, 8, dtype=torch.bfloat16), at_offset(1, 2, 16, 8),
                                            _t(1, 2, 16, 8, dtype=torch.bfloat16), _t(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="16-byte aligned"):
        call()
    assert recorded.calls == []


class _DeviceOnly(torch.Tensor):
    """A tensor that may not be read on the host, as ``lengths`` on the card."""

    def _host(self, *args, **kwargs):
        raise AssertionError("lengths was read on the host")

    item = tolist = cpu = numpy = _host
    __int__ = __index__ = __bool__ = __float__ = _host


@pytest.mark.parametrize("S, split, nsplit", [(16, 16, 1), (256, 256, 1), (512, 256, 2), (4096, 256, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_launches_split_then_combine(recorded, monkeypatch, S, split, nsplit, dtype):
    B, Hq, Hkv, D = 3, 6, 2, 64
    scratch = []
    empty = torch.empty

    def spy(*args, **kwargs):
        t = empty(*args, **kwargs)
        scratch.append(t)
        return t

    monkeypatch.setattr(torch, "empty", spy)
    lengths = torch.tensor([0, 1, S], dtype=torch.int32).as_subclass(_DeviceOnly)
    q, k, v = _t(B, Hq, D, dtype=dtype), _t(B, Hkv, S, D, dtype=dtype), _t(B, Hkv, S, D, dtype=dtype)
    kernel = ops.KERNELS["stitched_decode_attention"]
    before = kernel.launches
    o = ops.attention_decode(q, k, v, lengths)
    sfx = cuda.DTYPE_SUFFIX[dtype]
    assert [c[0] for c in recorded.calls] == [f"sx_decode_split_{sfx}", f"sx_decode_combine_{sfx}"]
    assert kernel.launches == before + 2
    # the scratch: f32 (B, Hq, splits, D + 2), a function of S alone
    assert stitched_attention.decode_splits(S) == (split, nsplit)
    [part] = [t for t in scratch if t.dtype == torch.float32 and t.dim() == 4]
    assert tuple(part.shape) == (B, Hq, nsplit, D + 2)
    (_, split_args), (_, combine_args) = recorded.calls
    assert split_args[:6] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                              part.data_ptr(), B)
    assert split_args[6:11] == (Hq, Hkv, S, D, split) and split_args[11] == nsplit
    assert combine_args == (part.data_ptr(), o.data_ptr(), B, Hq, D, nsplit, 0)  # 0: the stream


def test_bf16_softmax_weights_need_two_terms_at_full_width_limits(rng):
    """Why bf16 flash attention puts P into its P V product as two bf16
    terms (``csrc/stitched_attention.cu``).  With hi = bf16(p) alone, each
    weight moves by up to 2**-9 of itself, and outputs near 0 leave the
    full-width limit of ``chip_smoke.py`` (rtol 1e-2, atol 1e-4); with lo =
    bf16(p - hi) added, none does.  Plain torch on the tensor cores'
    rounding, causal, D = 64, bf16 q, k and v."""
    H, S, D = 4, 256, 64
    q, k, v = (torch.tensor(rng.randn(H, S, D).astype(np.float32)).bfloat16().float()
               for _ in range(3))
    s = (q @ k.transpose(1, 2)) * D ** -0.5
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    want = ((p @ v) / l).bfloat16().double()
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()

    def outside(o):
        return int((~torch.isclose(o.bfloat16().double(), want, rtol=1e-2, atol=1e-4)).sum())

    assert outside((hi @ v) / l) > 0.01 * want.numel()
    assert outside((hi @ v + lo @ v) / l) == 0


@pytest.mark.parametrize("T, block_tokens, per_block, blocks", [
    (4096, 256, 8, 512),   # full width: the grid fills the 132 SMs
    (4096, 4, 4, 1024),    # block_tokens caps the tokens of a block
    (12, 256, 8, 2),       # 12 tokens: the second block is 4 short
    (13, 256, 8, 2),
])
def test_gate_launches_a_warp_per_token(recorded, T, block_tokens, per_block, blocks):
    E, k = 40, 8
    logits = _t(T, E)
    kernel = ops.KERNELS["stitched_moe_gate"]
    before, by = kernel.launches, dict(kernel.by_symbol)
    w, i = ops.moe_gate(logits, top_k=k, block_tokens=block_tokens)
    assert [c[0] for c in recorded.calls] == ["sx_moe_gate_f32"]
    assert kernel.launches == before + 1
    assert kernel.by_symbol["sx_moe_gate_f32"] == by.get("sx_moe_gate_f32", 0) + 1
    # logits, w, idx, then T, E, top_k, tokens per block, blocks; the stream last
    assert recorded.calls[0][1] == (logits.data_ptr(), w.data_ptr(), i.data_ptr(),
                                    T, E, k, per_block, blocks, 0)
    assert per_block <= stitched_moe_gate.GATE_WARPS and per_block * blocks >= T
    if T == 4096 and block_tokens == 256:
        assert blocks >= 132


def _misaligned(*shape, dtype):
    """A contiguous view that starts 2 bytes into its storage."""
    return torch.zeros(int(np.prod(shape)) + 1, dtype=dtype)[1:].view(*shape)


@pytest.mark.parametrize("make_x, dtype, symbol, plan", [
    # x (4096, 1536) bf16: a warp a row, 8 rows a block
    (lambda dt: _t(4096, 1536, dtype=dt), torch.bfloat16, "sx_rmsnorm_vec_bf16", (1, 8)),
    # 1536 f32 is 384 words: two warps a row, 4 rows a block
    (lambda dt: _t(64, 1536, dtype=dt), torch.float32, "sx_rmsnorm_vec_f32", (2, 4)),
    # 16,384 bf16 is the widest row held: 8 warps, 1 row a block
    (lambda dt: _t(2, 16384, dtype=dt), torch.bfloat16, "sx_rmsnorm_vec_bf16", (8, 1)),
    # the scalar kernel: 600 bytes a row, 2 bytes off 16, too wide
    (lambda dt: _t(4, 300, dtype=dt), torch.bfloat16, "sx_rmsnorm_bf16", None),
    (lambda dt: _misaligned(4, 1536, dtype=dt), torch.bfloat16, "sx_rmsnorm_bf16", None),
    (lambda dt: _t(2, 16392, dtype=dt), torch.bfloat16, "sx_rmsnorm_bf16", None),
], ids=["4096x1536-bf16", "64x1536-f32", "2x16384-bf16", "4x300-bf16", "misaligned-bf16",
        "2x16392-bf16"])
def test_rmsnorm_takes_the_16_byte_kernel_where_it_can(recorded, make_x, dtype, symbol, plan):
    x = make_x(dtype)
    rows, cols = x.shape
    gamma = _t(cols, dtype=dtype)
    kernel = ops.KERNELS["stitched_rmsnorm"]
    before, by = kernel.launches, dict(kernel.by_symbol)
    y = ops.rmsnorm(x, gamma, eps=1e-6)
    assert [c[0] for c in recorded.calls] == [symbol]
    assert kernel.launches == before + 1
    assert kernel.by_symbol[symbol] == by.get(symbol, 0) + 1
    values = recorded.calls[0][1]
    assert values[:5] == (x.data_ptr(), gamma.data_ptr(), y.data_ptr(), rows, cols)
    assert values[-2] == pytest.approx(1e-6) and values[-1] == 0
    if plan is not None:
        # the warps that own a row, and the rows a block holds
        assert values[5:7] == plan
        assert 32 * plan[0] * plan[1] == stitched_rmsnorm.VEC_THREADS


def test_rmsnorm_block_rows_caps_the_16_byte_kernels_rows(recorded):
    x, gamma = _t(64, 1536, dtype=torch.bfloat16), _t(1536, dtype=torch.bfloat16)
    ops.rmsnorm(x, gamma, block_rows=2)
    ops.rmsnorm(x, gamma, block_rows=32)
    assert [c[1][5:7] for c in recorded.calls] == [(1, 2), (1, 8)]


@pytest.mark.parametrize("shape, dtype, blocks_per_row, slice_cols", [
    ((16, 49155), torch.float32, 8, 6145),     # full width: 16 clusters of 8, grid 128
    ((16, 49155), torch.bfloat16, 8, 6145),
    ((3, 4096), torch.float32, 8, 512),        # the narrowest cluster row: a value a thread
    ((2, 131072), torch.float32, 8, 16384),    # the widest: 32 values a thread
], ids=["16x49155-f32", "16x49155-bf16", "3x4096", "2x131072"])
def test_wide_softmax_rows_take_the_cluster_kernel(recorded, shape, dtype, blocks_per_row, slice_cols):
    x = _t(*shape, dtype=dtype)
    kernel = ops.KERNELS["stitched_softmax"]
    symbol = f"sx_softmax_cluster_{cuda.DTYPE_SUFFIX[dtype]}"
    before, by = kernel.launches, dict(kernel.by_symbol)
    y = ops.softmax(x)
    assert [c[0] for c in recorded.calls] == [symbol]
    assert kernel.launches == before + 1 and kernel.by_symbol[symbol] == by.get(symbol, 0) + 1
    # x, y, rows, cols, blocks a row (the cluster), columns a block; the stream last
    values = recorded.calls[0][1]
    assert values == (x.data_ptr(), y.data_ptr(), *shape, blocks_per_row, slice_cols, 0)
    assert blocks_per_row * slice_cols >= shape[1] > blocks_per_row * (slice_cols - 1)
    assert -(-slice_cols // stitched_softmax.CLUSTER_THREADS) <= stitched_softmax.CLUSTER_MAX_PER_THREAD
    if shape == (16, 49155):
        assert shape[0] * blocks_per_row == 128   # the grid: 128 of the 132 SMs


@pytest.mark.parametrize("shape, block_rows, plan", [
    ((16, 4095), None, (1, 512)),       # narrower than the cluster's threads
    ((8, 24), None, (8, 256)),          # narrow rows pack 8 to a block
    ((2, 131073), None, (1, 1024)),     # wider than the cluster holds
    ((16, 49155), 1, (1, 1024)),        # block_rows asks for the row kernel
    ((16, 49155), 4, (4, 1024)),
], ids=["16x4095", "8x24", "2x131073", "16x49155-block_rows=1", "16x49155-block_rows=4"])
def test_other_softmax_rows_take_the_row_kernel(recorded, shape, block_rows, plan):
    x = _t(*shape)
    kernel = ops.KERNELS["stitched_softmax"]
    before = kernel.by_symbol.get("sx_softmax_f32", 0)
    y = ops.softmax(x, block_rows=block_rows)
    assert [c[0] for c in recorded.calls] == ["sx_softmax_f32"]
    assert kernel.by_symbol["sx_softmax_f32"] == before + 1
    # x, y, rows, cols, rows a block, threads a block; the stream last
    assert recorded.calls[0][1] == (x.data_ptr(), y.data_ptr(), *shape, *plan, 0)
