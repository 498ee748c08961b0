"""The port's launch tools (``repro_torch.launch``: ``roofline``,
``costmodel``, ``hlostats``, ``dryrun``) — the counterparts of
``tests/test_launch.py`` and ``tests/test_latency.py``'s roofline test, then
the port held against ``repro`` on the same inputs.

Cost conventions where the two packages differ (``PERF.md`` §6, PR 23):

* ``dot_flops`` are equal exactly on the ten reduced configs' ``forward``,
  but for qwen2-vl-2b: the reference mixes the M-RoPE position streams by a
  one-hot ``dot_general`` (k = 3, one for q and one for k each layer), which
  the port computes by slices (``models/layers.py``), so the reference
  counts ``_mrope_one_hot(cfg)`` more.
* ``flops`` within ``FLOPS_RTOL``: torch's backward and fused ops
  (``silu``, ``_softmax``) are single ops where jnp writes several
  primitives.
* ``bytes_min`` within ``BYTES_MIN_RTOL``; ``bytes`` between
  ``BYTES_RATIO``: a torch view moves nothing and is charged nothing, where
  the reference charges each reshape, transpose and broadcast its output
  (measured here: 0.73-0.92 of the reference's ``bytes``).

Tests that start a fake process group destroy it before they return.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES, SHAPES
from repro_torch.launch import costmodel as tcost
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import hlostats as thlo
from repro_torch.launch import roofline as troof

FLOPS_RTOL = 2e-2
BYTES_MIN_RTOL = 0.1
BYTES_RATIO = (0.7, 1.0)
TRAIN_DOT_SHORTFALL = 0.06
TOKENS = (2, 16)


@pytest.fixture
def fake_world():
    """An in-process fake world of ``n`` ranks (torch's ``fake`` backend),
    destroyed when the test ends."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)

    try:
        yield start
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------- tests/test_launch.py's seven
def test_input_specs_cover_every_cell():
    for arch in ARCHITECTURES:
        for shape in SHAPES:
            specs = tdry.input_specs(arch, shape)
            leaves = list(tcost._tensors(specs))
            assert leaves and all(t.device.type == "meta" for t in leaves)
            if SHAPES[shape]["kind"] == "decode":
                assert tuple(specs["tokens"].shape) == (SHAPES[shape]["global_batch"],)


def test_long_context_skips_match_design():
    skipped = {a for a in ARCHITECTURES if tdry.cell_is_skipped(a, "long_500k") is not None}
    assert skipped == {
        "llama4-scout-17b-a16e", "granite-moe-3b-a800m", "qwen1.5-0.5b",
        "mistral-large-123b", "granite-20b", "qwen2.5-14b", "qwen2-vl-2b",
        "whisper-base",
    }
    assert tdry.cell_is_skipped("mamba2-1.3b", "long_500k") is None
    assert tdry.cell_is_skipped("hymba-1.5b", "long_500k") is None


def test_cost_counts_loop_bodies():
    """A loop's body counts once per trip: the port's loops are Python
    loops, so every trip dispatches its ops (the reference's scan x
    length)."""
    def f(x, w):
        for _ in range(7):
            x = torch.tanh(x @ w)
        return x

    x, w = torch.empty(8, 16), torch.empty(16, 16)
    cost = tcost.fn_cost(f, x, w)
    assert cost["dot_flops"] == pytest.approx(7 * 2 * 8 * 16 * 16)


def test_cost_dot_exact():
    a, b = torch.empty(4, 8, 16), torch.empty(4, 16, 32)
    cost = tcost.fn_cost(lambda a, b: torch.einsum("bik,bkj->bij", a, b), a, b)
    assert cost["dot_flops"] == 2 * 4 * 8 * 32 * 16


def test_cost_counts_remat_recompute():
    from torch.utils.checkpoint import checkpoint

    def g(x):
        return torch.sum(torch.tanh(x) ** 2)

    def grad_of(fn):
        def run(x):
            x = x.detach().requires_grad_(True)
            with torch.enable_grad():
                return torch.autograd.grad(fn(x), x)[0]
        return run

    def remat(x):
        return checkpoint(g, x, use_reentrant=False)

    x = torch.empty(64)
    with_remat = tcost.fn_cost(grad_of(remat), x)["flops"]
    without = tcost.fn_cost(grad_of(g), x)["flops"]
    assert with_remat > without


def test_collective_census_scales_by_trip_count(fake_world):
    """An all-reduce in a 5-trip loop body and an all-gather outside it: a
    traced ``scan`` and a counted Python loop give the reference's census."""
    from torch._higher_order_ops.scan import scan
    from torch.distributed.device_mesh import init_device_mesh
    from torch.fx.experimental.proxy_tensor import make_fx

    fake_world(2)
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    g = mesh.get_group("model").group_name
    c10d = torch.ops._c10d_functional

    def traced(a, xs):
        ag = c10d.wait_tensor(c10d.all_gather_into_tensor(a, 2, g))

        def body(c, x):
            r = c10d.wait_tensor(c10d.all_reduce(c + x, "sum", g))
            return r, r.clone()

        c, _ = scan(body, a, xs)
        return ag, c

    def looped(a):
        ag = c10d.wait_tensor(c10d.all_gather_into_tensor(a, 2, g))
        for _ in range(5):
            a = c10d.wait_tensor(c10d.all_reduce(a, "sum", g))
        return ag, a

    gm = make_fx(traced, tracing_mode="fake")(torch.zeros(8), torch.zeros(5, 8))
    _, mode = tcost.count(looped, torch.empty(8, device="meta"))
    for out in (thlo.collective_bytes(gm), thlo.collective_bytes(mode)):
        assert out["all-gather"] == 16 * 4                 # once, outside the loop
        assert out["all-reduce"] == 5 * 8 * 4              # 5 loop trips


def test_one_device_cell_lowers_and_compiles(fake_world, monkeypatch):
    """``build_cell`` on a 1 x 1 fake mesh with a reduced arch and a tiny
    train shape: both functions count, with no 256-rank world."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, reduced_config

    fake_world(1)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    cfg = reduced_config(get_config("qwen1.5-0.5b"))
    monkeypatch.setattr(tdry, "get_config", lambda name: cfg)
    monkeypatch.setitem(tdry.SHAPES, "tiny", dict(seq_len=16, global_batch=2, kind="train"))
    cell = tdry.build_cell("qwen1.5-0.5b", "tiny", mesh, 1)
    rec = tdry.measure_cell(cell, "1x1", 1, "qwen1.5-0.5b", "tiny", 0.0)
    assert rec["flops"] > 0 and rec["dot_flops"] > 0
    # gathers of the params and the gradients' sum, over groups of one rank
    assert set(rec["collective_bytes"]) == {"all-gather", "all-reduce"}
    assert rec["memory"]["temp_size_in_bytes"] > 0


@pytest.mark.parametrize("arch,kind", [("qwen1.5-0.5b", "prefill"), ("qwen1.5-0.5b", "decode"),
                                       ("mamba2-1.3b", "decode"), ("granite-moe-3b-a800m", "train"),
                                       ("qwen1.5-0.5b", "train"), ("mamba2-1.3b", "train")])
def test_cells_of_every_kind_on_a_2x2_fake_world(fake_world, monkeypatch, arch, kind):
    """Rank 0's function of each kind of cell on a (data 2, model 2) fake
    mesh, reduced configs: its census has the collectives its kind runs,
    and the global function's product FLOPs are the reference's ``fn_cost``
    of the reference's cell function: equal for prefill and decode; for
    train at most ``TRAIN_DOT_SHORTFALL`` lower, since the reference
    rematerializes each attention q chunk in its backward even under remat
    "none" (``src/repro/models/layers.py:154``), and its transpose of a
    contraction-free einsum product is a ``dot_general`` where torch's
    autograd runs an elementwise ``mul`` (measured: 0.56-5.5%)."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro.configs import get_config as rget
    from repro.configs import reduced_config as rred
    from repro.launch import dryrun as rdry
    from repro.launch.costmodel import fn_cost as rfn_cost
    from repro_torch.configs import get_config, reduced_config

    fake_world(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = reduced_config(get_config(arch))
    monkeypatch.setattr(tdry, "get_config", lambda name: cfg)
    monkeypatch.setitem(tdry.SHAPES, "tiny", dict(seq_len=16, global_batch=4, kind=kind))
    cell = tdry.build_cell(arch, "tiny", mesh, 1)
    rec = tdry.measure_cell(cell, "2x2", 4, arch, "tiny", 0.0)
    assert rec["flops"] > 0 and rec["memory"]["temp_size_in_bytes"] > 0
    assert "all-gather" in rec["collective_bytes"]
    assert ("all-reduce" in rec["collective_bytes"]) == (kind == "train")
    # the reference's global function of the same cell, on its specs
    rcfg = rred(rget(arch))
    if kind in ("train", "prefill"):
        rcfg = dataclasses.replace(rcfg, activation_sharding="sp")
    if kind == "decode" and rcfg.family != "ssm":
        rcfg = dataclasses.replace(rcfg, kv_cache_dtype="int8")
    orig = dict(rdry.SHAPES)
    monkeypatch.setattr(rdry, "get_config", lambda name: rcfg)
    rdry.SHAPES["tiny"] = dict(seq_len=16, global_batch=4, kind=kind)
    try:
        rspecs = rdry.input_specs(arch, "tiny", rcfg)
    finally:
        rdry.SHAPES.clear()
        rdry.SHAPES.update(orig)
    from repro.models import decode_step as rdecode
    from repro.models import forward as rforward
    from repro.models import param_specs as rparam_specs
    from repro.models import layers as rL
    from repro.train import AdamWConfig, adamw_init_specs, make_train_step

    rp = rparam_specs(rcfg)
    if kind == "train":
        step = make_train_step(rcfg, AdamWConfig(total_steps=10000), accum_steps=1)
        want = rfn_cost(step, rp, adamw_init_specs(rp), rspecs)
    elif kind == "prefill":
        want = rfn_cost(lambda p, b: rL.unembed(
            p["embed"], rforward(p, b, rcfg, return_hidden=True)[:, -1]), rp, rspecs)
    else:
        want = rfn_cost(lambda p, c, t, pos: rdecode(p, c, t, pos, rcfg), rp,
                        rspecs["cache"], rspecs["tokens"], rspecs["pos"])
    if kind == "train":
        assert (1 - TRAIN_DOT_SHORTFALL) * want["dot_flops"] <= rec["dot_flops"] <= want["dot_flops"]
    else:
        assert rec["dot_flops"] == want["dot_flops"]


def test_dryrun_and_roofline_entry_points(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun`` writes a record a cell, and
    ``python -m repro_torch.launch.roofline`` reads them into its table."""
    out = str(tmp_path / "dryrun")
    assert tdry.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k", "--multi-pod", "off",
                      "--out", out]) == 0
    assert troof.main(["--dir", out, "--json-out", str(tmp_path / "rows.json")]) == 0
    text = capsys.readouterr().out
    assert "| qwen1.5-0.5b | decode_32k |" in text and "dry-run complete" in text
    assert (tmp_path / "rows.json").exists()


# -------------------------------------------- tests/test_latency.py's roofline
def test_roofline_constants_derive_from_h100():
    from repro_torch.core.latency import H100, LatencyModel

    assert troof.PEAK_FLOPS == H100.peak_flops_bf16 == 989e12
    assert troof.HBM_BW == H100.hbm_bw == 3.35e12
    assert troof.ICI_BW == H100.ici_bw == 900e9
    m = LatencyModel(H100)
    assert m.compute_time(H100.peak_flops_bf16) == pytest.approx(1.0)
    assert m.memory_time(H100.hbm_bw, chips=2) == pytest.approx(0.5)
    assert m.collective_time(H100.ici_bw) == pytest.approx(1.0)


# ----------------------------------------------------- the port against repro
def _shape_dtype(t):
    if isinstance(t, jax.ShapeDtypeStruct):
        return tuple(t.shape), np.dtype(t.dtype).name
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
        return out
    return {prefix: _shape_dtype(tree)}


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_input_specs_equal_the_reference(arch):
    from repro.launch.dryrun import input_specs as rinput_specs

    for shape in SHAPES:
        want = _paths(rinput_specs(arch, shape))
        got = _paths(tdry.input_specs(arch, shape))
        assert got == want, (arch, shape)


def test_skips_and_model_flops_equal_the_reference():
    from repro.launch.dryrun import cell_is_skipped
    from repro.launch.roofline import model_flops

    for arch in ARCHITECTURES:
        for shape in SHAPES:
            assert tdry.cell_is_skipped(arch, shape) == cell_is_skipped(arch, shape)
            assert troof.model_flops(arch, shape) == model_flops(arch, shape)


class _RefMesh:
    """A 16 x 16 mesh as the reference's rules read it: axis names and a
    shape dict."""
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


@pytest.mark.parametrize("B,S", [(256, 4096), (32, 32768), (8, 1024), (1, 524288)])
def test_auto_accum_equals_the_reference(fake_world, B, S):
    from torch.distributed.device_mesh import init_device_mesh

    from repro.configs import get_config as rget
    from repro.launch.dryrun import auto_accum
    from repro_torch.configs import get_config as tget

    fake_world(256)
    mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
    for arch in ARCHITECTURES:
        want = auto_accum(rget(arch), B, S, _RefMesh())
        assert tdry.auto_accum(tget(arch), B, S, mesh) == want, arch


def _records():
    """Dry-run records of every cell on the 16 x 16 mesh, their numbers
    drawn from a seed, the skipped cells as skips and one error."""
    rng = np.random.default_rng(0)
    out = []
    for arch in sorted(ARCHITECTURES):
        for shape in SHAPES:
            skip = tdry.cell_is_skipped(arch, shape)
            if skip:
                out.append({"arch": arch, "shape": shape, "mesh": "16x16", "skip": skip})
                continue
            out.append({
                "arch": arch, "shape": shape, "mesh": "16x16", "num_devices": 256,
                "flops": float(rng.uniform(1e12, 1e17)),
                "bytes_accessed": float(rng.uniform(1e10, 1e15)),
                "bytes_min": float(rng.uniform(1e9, 1e13)),
                "collective_bytes": {"all-gather": float(rng.uniform(1e8, 1e11)),
                                     "all-reduce": float(rng.uniform(1e8, 1e11))},
            })
    out.append({"arch": "qwen1.5-0.5b", "shape": "train_4k", "mesh": "16x16", "error": "x"})
    return out


def test_analyze_under_tpu_v5e_equals_the_reference():
    from repro.launch.roofline import _advice as radvice
    from repro.launch.roofline import analyze as ranalyze
    from repro.launch.roofline import to_markdown as rmarkdown
    from repro_torch.core.latency import TPU_V5E

    rows_r, rows_t = [], []
    for rec in _records():
        want = ranalyze(dict(rec))
        got = troof.analyze(dict(rec), TPU_V5E)
        assert got == want
        if want is not None:
            assert troof._advice(got).split(":")[0] == radvice(want).split(":")[0]
        rows_r.append(want or rec)
        rows_t.append(got or rec)
    assert troof.to_markdown(rows_t) == rmarkdown(rows_r)


def _forward_specs(arch):
    from repro.configs import get_config as rget
    from repro.configs import reduced_config as rred
    from repro_torch.configs import get_config as tget
    from repro_torch.configs import reduced_config as tred

    rc, tc = rred(rget(arch)), tred(tget(arch))
    B, S = TOKENS
    rb = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    tb = {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}
    if rc.family == "vlm":
        rb["patches"] = jax.ShapeDtypeStruct((B, rc.num_patches, rc.d_model), rc.jax_dtype)
        tb["patches"] = torch.empty((B, tc.num_patches, tc.d_model), dtype=tc.torch_dtype,
                                    device="meta")
    if rc.family == "audio":
        rb["frames"] = jax.ShapeDtypeStruct((B, rc.encoder_seq, rc.d_model), rc.jax_dtype)
        tb["frames"] = torch.empty((B, tc.encoder_seq, tc.d_model), dtype=tc.torch_dtype,
                                   device="meta")
    return rc, tc, rb, tb


def _mrope_one_hot(cfg):
    """The reference's one-hot M-RoPE products (module docstring): one a
    rotary application, for q and k in each layer, 2 · B · S · (hd / 2) · 3
    FLOPs each over the text and patch positions."""
    if cfg.family != "vlm":
        return 0.0
    B, S = TOKENS
    return 2 * cfg.num_layers * 2.0 * B * (S + cfg.num_patches) * (cfg.head_dim // 2) * 3


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_fn_cost_of_forward_matches_the_reference(arch):
    from repro.launch.costmodel import fn_cost as rfn_cost
    from repro.models import forward as rforward
    from repro.models import param_specs as rparam_specs
    from repro_torch.models import forward as tforward
    from repro_torch.models import param_specs as tparam_specs

    rc, tc, rb, tb = _forward_specs(arch)
    want = rfn_cost(lambda p, b: rforward(p, b, rc), rparam_specs(rc), rb)
    got = tcost.fn_cost(lambda p, b: tforward(p, b, tc), tparam_specs(tc), tb)
    assert got["dot_flops"] == want["dot_flops"] - _mrope_one_hot(rc)
    np.testing.assert_allclose(got["flops"], want["flops"], rtol=FLOPS_RTOL)
    np.testing.assert_allclose(got["bytes_min"], want["bytes_min"], rtol=BYTES_MIN_RTOL)
    lo, hi = BYTES_RATIO
    assert lo * want["bytes"] <= got["bytes"] <= hi * want["bytes"]


def test_counting_mode_tracks_live_bytes():
    """The peak of live bytes: at most two 4 KB temporaries alive at once
    (b and c, while c's 4-byte sum is made); the argument is not counted as
    made."""
    def f(x):
        a = x * 2.0
        b = a + 1.0
        del a
        c = b * 3.0
        return c.sum()

    _, mode = tcost.count(f, torch.empty(1024, device="meta"))
    assert mode.peak_live_bytes == 2 * 4096 + 4
    assert mode.live_bytes == 4           # the scalar sum remains


# ----------------------------------------------------------- a production cell
def test_a_production_cell_runs_on_a_fake_256_rank_world():
    """``run_cell`` of qwen1.5-0.5b x decode_32k: it starts a fake world of
    256 ranks, counts both functions and destroys the world.  (train_4k
    takes about 40 s alone on this CPU, too near 60 s when six test workers
    share it; the decode cell is the smallest.)"""
    import torch.distributed as dist

    t0 = time.time()
    rec = tdry.run_cell("qwen1.5-0.5b", "decode_32k", False, verbose=False)
    assert time.time() - t0 < 60
    assert not dist.is_initialized()
    # the reference's record keys (src/repro/launch/dryrun.py run_cell)
    keys = {"arch", "shape", "mesh", "num_devices", "flops", "dot_flops", "bytes_accessed",
            "xla_flops", "xla_bytes_accessed", "collective_bytes", "collective_bytes_unscaled",
            "memory", "lower_s", "compile_s", "accum_steps"}
    assert keys <= set(rec)
    assert set(rec["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                  "temp_size_in_bytes", "generated_code_size_in_bytes"}
    assert rec["xla_flops"] is None and rec["memory"]["generated_code_size_in_bytes"] is None
    assert rec["num_devices"] == 256 and rec["flops"] > 0
    assert rec["collective_bytes"]["all-gather"] > 0
    row = troof.analyze(rec)
    assert row["dominant"] in ("compute", "memory", "collective") and row["model_flops"] > 0
