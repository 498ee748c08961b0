"""The port's compiled graphs and kernels against the reference's.

On the CPU the port runs every kernel's plain version (the block
interpreter); the reference runs its Pallas kernels in interpret mode.
Outputs agree at rtol/atol 2e-5, the reference suite's own tolerance
(``tests/conftest.py``).  The CUDA source is checked as text here; it is
built and run against the plain versions on the card by ``chip_smoke.py``.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphs import ALL_GRAPHS, random_feeds
from repro.core import StitchOptions as RefOptions
from repro.core import compile_module as ref_compile
from repro.core import reference_execute as ref_execute
from repro_torch.core import compile_module, cuda_build
from repro_torch.core.interop import module_from_reference

TOL = 2e-5
# Speech normalises each (utterance, filter) column by rsqrt(var + 1e-5).
# Where every frame of a column is clamped at log(1e-6) the column is
# constant, its true centred value is 0, and what each package computes is
# the roundoff of a 50-term mean (1-2 ulp of 13.8) times 316; JAX, torch and
# a sequential sum round that mean differently.  Those outputs are held at
# this bound, every other output at TOL.
DEGENERATE_TOL = 1e-3


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64),
        rtol=tol, atol=tol, err_msg=what,
    )


def _degenerate_speech_outputs(feeds):
    """Mask of Speech outputs (B, 2F) fed by a constant normalised column."""
    x, w = feeds["frames"], feeds["mel"]
    B, T, F = x.shape
    mel = ((x * x).reshape(B * T, F) @ w).reshape(B, T, F)
    const = (mel < 1e-6).all(axis=1)                        # (B, F)
    return np.concatenate([const, const], axis=1)


@pytest.mark.parametrize("name", list(ALL_GRAPHS))
def test_compiled_graph_matches_reference(name):
    ref_module = ALL_GRAPHS[name]()
    feeds = random_feeds(ref_module, np.random.RandomState(0))
    port = compile_module(module_from_reference(ref_module), device="cpu")
    got = port(feeds)
    want_compiled = ref_compile(ref_module, RefOptions())(feeds)
    want_oracle = ref_execute(ref_module, feeds)
    assert got.keys() == want_oracle.keys() == want_compiled.keys()
    for k in want_oracle:
        assert got[k].device.type == "cpu"
        for want, what in ((want_compiled[k], "repro compile_module"),
                           (want_oracle[k], "repro reference_execute")):
            g, want = got[k].numpy(), np.asarray(want)
            if name == "Speech":
                bad = _degenerate_speech_outputs(feeds)
                assert 0 < bad.sum() < bad.size / 10
                _close(g[bad], want[bad], f"{name}:{k} vs {what}", DEGENERATE_TOL)
                g, want = g[~bad], want[~bad]
            _close(g, want, f"{name}:{k} vs {what}")


@pytest.mark.parametrize("name", ["StitchPipe", "NMT"])
def test_plain_kernel_matches_reference_kernel(name, rng):
    ref_module = ALL_GRAPHS[name]()
    ref = ref_compile(ref_module, RefOptions())
    port = compile_module(module_from_reference(ref_module), device="cpu")
    (fname, ref_kernel), = ref.executable.kernels.items()
    port_kernel = port.executable.kernels[fname]
    assert port_kernel.fn.emitter == ("emit_stitched_fusion" if name == "StitchPipe" else "emit_fusion")
    args = [rng.uniform(-1, 1, i.shape).astype(np.float32) for i in ref_kernel.inputs]
    want = ref_kernel(*[jnp.asarray(a) for a in args])
    got = port_kernel.fn.plain(*[torch.as_tensor(a) for a in args], device=torch.device("cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        _close(g.numpy(), w, f"{name}:{fname}")
    assert port_kernel.fn.launches == 0    # the plain version is no launch


def test_generated_source_has_one_kernel_per_unique_signature():
    module = module_from_reference(ALL_GRAPHS["BiRNN"]())
    port = compile_module(module, device="cpu")
    src = port.cuda_source
    assert port.stats.unique_kernels == 3 < port.stats.stitched_kernels
    assert len(re.findall(r"__global__ void", src)) == port.stats.unique_kernels
    assert len(re.findall(r'extern "C" int \w+_launch\(', src)) == port.stats.unique_kernels
    assert src.startswith('#include "stitch_runtime.cuh"')
    names = {k.fn.name for k in port.kernels}
    assert all(f"__launch_bounds__(256) {n}(" in src for n in names)
    cmd = cuda_build._command("nvcc", cuda_build.BUILD_DIR / "x.cu", cuda_build.BUILD_DIR / "x.so")
    joined = " ".join(cmd[1:])
    assert "fast_math" not in joined and "fast-math" not in joined
    assert "arch=compute_90a,code=sm_90a" in joined
    assert "-shared" in cmd and "-fPIC" in cmd


def test_stitched_source_loops_over_its_phases():
    port = compile_module(module_from_reference(ALL_GRAPHS["StitchPipe"]()), device="cpu")
    (kernel,) = port.kernels
    assert kernel.num_phases == 2 and kernel.blocks == 17
    src = port.cuda_source
    assert "<<<1, 1024, 0," in src                    # one block, as grid=(1,)
    assert "for (int b = 0; b < 16; ++b)" in src      # phase 0 loops its blocks
    assert src.count("// phase ") == 2
