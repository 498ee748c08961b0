#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out PATH]

Phases, each fatal on failure:

1. device — the card's name, the device count, and nvidia-smi's name and
   power limit;
2. build — compile the ten paper graphs (``repro_torch.graphs``) under the
   default ``StitchOptions``: every graph's generated ``.cu`` is built with
   nvcc (one process per source, all started together) into
   ``build/repro_torch/``, then each graph is compiled for ``"cuda"``;
3. main path — one call of every compiled graph on seeded feeds, through
   the eager step loop (``jit_replay=False``, so each launch goes through
   its wrapper), with every kernel's launch counter set to 0 just before
   and read just after: each graph must launch exactly its planned fused
   kernels (35 in all) and every unique kernel at least once;
4. right — each graph's outputs against the port's ``reference_execute`` on
   the card (one torch op per instruction), and every unique kernel against
   its plain version on the card, on the inputs the main path gave it.
   Then the stitched compiles beside the main path (``STITCHED_COMPILES``):
   StitchPipe under ``stitch_max_blocks`` 1 and 4 and ``max_blocks`` 8 and
   64 (phase 0 in 1, 4, 8 and 16 plan blocks; at 1 its slots outgrow shared
   memory and live in the workspace) and the (32, 48) break module of
   ``tests/test_stitching.py``, built with the port's own ``trace``, phases
   of 2 and 1 plan blocks.  Each takes one launch and is held against its
   plain version at ``TOL``.  Then the compiles in the dtypes the graphs do
   not use (``DTYPE_COMPILES``): an add, a mul, two row reduces and a
   convert in bf16, int8 and int16 through ``emit_fusion``, and the break
   module in bf16 and an integer kin of it in int8 through
   ``emit_stitched_fusion``, and a (128, 512) softmax in one plan block
   whose slots pass a block's shared memory (``FUSION_COMPILES``): each
   launch counted, every kernel held against its plain version and the
   outputs against ``reference_execute``, bf16 at one ulp, int8 exactly;
5. numbers — CUDA-event times: microseconds per call of each compiled graph
   and of ``reference_execute``, and per launch of each kernel and of its
   plain version, beside the kernel's bound (bytes in and out over 3.35
   TB/s, or f32 operations over 67 TFLOP/s, whichever is larger).  Back to
   back, these launches are paced by the host, so ``torch.profiler`` also
   gives each kernel's device time, and each graph's device kernels and
   device time per call, from which its device idle share follows, and the
   device time of each graph's unfused ``reference_execute`` (the yardstick
   of StitchPipe's stitched kernel).  Each ``emit_fusion`` kernel's line
   also gives its members, plan blocks, grid, threads, bytes of shared
   memory, and ``ptxas``'s registers and spill bytes.

6. kernels — the hand-written kernels of ``repro_torch.kernels`` through
   their public entry point ``repro_torch.kernels.ops``, at the full width
   of granite-moe-3b-a800m: rmsnorm, the sampler's softmax over the vocab,
   causal GQA prefill attention, GQA decode attention over a KV cache with
   seeded lengths, and the MoE router gate.  The counters are set to 0
   just before those five calls and must read just after one launch each,
   two for decode (its split and combine kernels), through the expected
   launchers (``launchers``: bf16 flash on the tensor-core kernel, RMSNorm
   on its 16-byte kernel ``sx_rmsnorm_vec_kernel``, the vocab softmax on
   its cluster kernel ``sx_softmax_cluster_kernel``), and the gate's grid
   must hold at least 132 blocks (one per SM).  Then
   the small shapes of ``tests/test_kernels.py`` (f32, G = 8, D = 8 and 16,
   non-causal, E = 8..64 with k = 1..8), each call through its expected
   launchers (f32 flash on the f32 kernel), and calls the small sweep of
   the test file leaves out: flash and decode attention at D = 32 and 128
   in f32 and bf16 (the default blocks, whose f32 K/V tiles need more than
   48 KB of shared memory at D = 128), flash with block_q != block_k, bf16
   flash at S = 48 and 80 (not multiples of its 64-row tile) with D = 8, 16
   and 64 and G = 8, bf16 decode at lengths 0, 1, split - 1, split, split
   + 1 and S with G = 1, 3 and 8 and D = 64 and 128, softmax and
   rmsnorm at 16 and 32 rows per block, the gate at E = 32, 33, 64, 65,
   128 and 256 (1, 2, 4 and 8 slots a lane), at T = 4100 (a short last
   block) and on rows whose softmax is NaN (a NaN logit, a +inf logit,
   only -inf) in f32 and bf16, and rmsnorm on its scalar kernel
   ``sx_rmsnorm_kernel`` (bf16 d = 300, a view 2 bytes off 16, d = 16,392
   past the width held in registers) and on its 16-byte kernel at f32 d =
   1536 and bf16 d = 16,384, and softmax where its cluster kernel
   splits: rows that start off 16 bytes (r % 4 != 0 at 49,155 and 10,001
   columns), widths 4,095 (the row kernel), 4,096 and 4,097 (the cluster),
   131,072 (the widest cluster row) and 131,073 (the row kernel again),
   bf16 at full width, rows with one block's slice wholly -inf, and rows
   that are NaN across (a NaN, a +inf, only -inf).  Every call is held against its
   plain version on the same inputs.  The small shapes keep the test
   file's rtol = atol: 2e-5 in f32 and 3e-2 in bf16, 2e-4 and 5e-2 for
   attention.  At full width the limits follow from the outputs they check
   (``FULL_TOL``).  The gate's indices may differ from the plain version's
   only where the two picks' probabilities are within 2e-6 (``expf`` on
   the card and torch's ``exp`` round differently); the count of such
   picks is printed.  At full width: CUDA-event times of the kernel, of its
   plain version and of one PyTorch library call that computes the same
   function (timed only: the port never calls it), the profiler's device
   time of the kernel and of the library call (the sum over every device
   kernel each runs), and the bound: bytes over 3.35 TB/s or operations
   over the peak of their type (989 TFLOP/s bf16 for attention, 67 TFLOP/s
   f32 otherwise).  RMSNorm's 25 MB fit in the 50 MB L2, so its device
   time and ``F.rms_norm``'s are also taken over a rotation of 8 inputs
   (101 MB of x), where each call finds its x in device memory.

7. replay — each graph compiled with the default options: its
   ``replay_mode`` must be the one its dispatch counts give (the CUDA graph
   where a replayed call dispatches no more than an eager one), and a
   default call must take that path.  Then every graph replays through its
   CUDA graph (``jit_execute``): two calls, each bit for bit equal to its
   eager call (a library dot that rounds differently under capture would be
   named and held at ``TOL``); microseconds per call eager and replayed
   (CUDA events, 200 calls), device microseconds and idle share both ways.
   The launches of a replayed call are read from torch.profiler: each
   generated kernel as many times a call as the plan launches it, and
   every device kernel of the eager call plus one a copy group of the
   feeds and roots (a profile that disagrees is retaken, then fails); the
   counters' replay ticks are the plan's bookkeeping, held against the plan;
8. loops — the RNN cell as a scan (``RNNScan``), the decode loop and the
   reversed scan of ``repro_torch.graphs.LOOP_GRAPHS``, eager and replayed:
   launches counted (the body's kernels once an iteration; replayed, by the
   profiler as in phase 7), outputs against the plain path
   (``reference_execute``, the body interpreted op by op) and, for the scan,
   its final state against the unrolled RNN graph's;
9. verify — ``python -m repro_torch.lint`` in-process on the card: the ten
   graphs under ``verify="strict"`` in both planners, exit status 0;
10. autotune — the ten graphs compiled with ``autotune=True`` into a fresh
   store under ``build/repro_torch/``, in each planner: under the greedy
   planner twice, and the second compile must take no new measurement;
   under the cost planner ``AUTOTUNE_ROUNDS`` times, reported (it re-plans
   from what it measured and measures what it newly commits).  In both a
   compile measures only kernels the store does not hold; measurements
   and store hits per compile, ``model_error_pct``, whether the plan
   changed from the default one, and the last plan's outputs against
   ``reference_execute``;
11. f16 and the fault modules — the five hand-written kernels in f16 at
   granite-moe-3b-a800m's full width through their f16 launchers, each
   against its plain version (``F16_TOL``) and timed as in phase 6; and the
   two modules that reached the emitters' former limits (a concat of
   composed reshapes; a SHARE member reading its slot transposed, which
   writes through the workspace's staging region), one launch each, against
   their plain versions and ``reference_execute``.

The line before the last is one JSON object with a ``kernels`` list: one
entry per emitter (``emit_fusion`` and ``emit_stitched_fusion``) and one
per hand-written kernel (with its f16 numbers as ``f16_*`` keys); the last
line is ``{"ok": true, "device": {...}}``.  ``--out`` also writes every per-graph and per-kernel number as
JSON, with nvcc's register, shared-memory and spill lines.  Exits
non-zero with no result when no card is present.
"""
import argparse
import itertools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM data-sheet peaks (dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# granite-moe-3b-a800m, written out because this script imports nothing of
# the JAX package: src/repro/configs/granite_moe_3b_a800m.py:5-10 and the
# bf16 dtype and norm_eps of src/repro/configs/base.py:50-51
GRANITE = dict(d_model=1536, heads=24, kv_heads=8, head_dim=64, experts=40,
               top_k=8, vocab=49155, norm_eps=1e-6)

# Outputs are held at rtol = atol = TOL: the kernels accumulate sums and
# dot products in f32 in another order than torch's reductions and matmul,
# which moves results by a few ulp.  Speech is the exception: it normalises
# each (utterance, filter) column by rsqrt(var + 1e-5), and where every frame
# of a column is clamped at log(1e-6) the true centred value is 0 and what
# any implementation returns is a 50-term mean's roundoff (1-2 ulp of 13.8)
# times 316.  Those outputs, and only those, are held at DEGENERATE_TOL.
TOL = 2e-5
DEGENERATE_TOL = 1e-3

WARMUP = 10
CALLS = 200          # timed calls of a compiled graph, a kernel or the oracle
PLAIN_CALLS = 20     # timed calls of a plain (block-interpreted) kernel
PROFILED_CALLS = 20  # calls traced by torch.profiler for device times
KERNEL_CALLS = 50    # timed calls of a hand-written kernel or its library call
FULL_PLAIN_CALLS = 5  # timed calls of a hand-written kernel's plain version
COLD_ROTATION = 8    # full-width RMSNorm inputs cycled to time it with a cold L2

# kernel vs plain version in phase 6 (tests/test_kernels.py:16,70,82): the
# kernels sum in another order than torch, and cast to bf16 once at the end
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
ATTENTION_TOL = {"float32": 2e-4, "bfloat16": 5e-2}
GATE_TIE = 2e-6      # gate picks may swap only between probabilities this close


def softmax_transpose(b, x, g):
    """The break module of tests/test_stitching.py: a row softmax feeding a
    2-D transpose, a schedule break once (32, 48) passes the replicate limit."""
    scaled = x * b.broadcast(g, x.shape, (1,))
    mx = b.reduce(scaled, (1,), "max")
    e = b.exp(scaled - b.broadcast(mx, x.shape, (0,)))
    s = b.reduce(e, (1,), "sum")
    p = e / b.broadcast(s, x.shape, (0,))
    t = b.transpose(p, (1, 0))
    return b.tanh(t) * 0.5


# stitched compiles beside the main path: (label, module, StitchOptions fields,
# plan blocks of each phase)
STITCHED_COMPILES = [
    ("StitchPipe stitch_max_blocks=1", "StitchPipe", {"stitch_max_blocks": 1}, [1, 1]),
    ("StitchPipe stitch_max_blocks=4", "StitchPipe", {"stitch_max_blocks": 4}, [4, 1]),
    ("StitchPipe max_blocks=8", "StitchPipe", {"max_blocks": 8}, [8, 1]),
    ("StitchPipe max_blocks=64", "StitchPipe", {"max_blocks": 64}, [16, 1]),
    ("break (32, 48) max_blocks=32 replicate_limit=1024", "break",
     {"max_blocks": 32, "replicate_limit": 1024}, [2, 1]),
]


def arith(b, x, y):
    """An add, a mul, two row reduces and a convert to f32."""
    s = (x + y) * y
    return b.reduce(s, (1,), "sum"), b.reduce(s, (1,), "max"), b.convert(s, "float32")


def int_break(b, x, g):
    """The break module's integer kin: a row max feeding a transpose."""
    s = x * b.broadcast(g, x.shape, (1,))
    d = s - b.broadcast(b.reduce(s, (1,), "max"), x.shape, (0,))
    t = b.transpose(d, (1, 0))
    return t + t


# compiles beside the main path in the dtypes the graphs do not use, each
# through the emitter named: (label, module, dtype, StitchOptions fields,
# emitter, (rtol, atol)).  bf16 values round where each member ends; a sum
# accumulates in f32 in another order than torch's, and exp and tanh of the
# card and of torch may differ by an f32 ulp, so either may tip a bf16
# rounding: held at one bf16 ulp (2**-7), plus 2**-12 near 0.  int8 wraps
# exactly.
DTYPE_COMPILES = [
    ("arith bf16 (64, 128)", "arith", "bfloat16", {}, "emit_fusion", (2.0 ** -7, 2.0 ** -12)),
    ("arith int8 (64, 128)", "arith", "int8", {}, "emit_fusion", (0.0, 0.0)),
    ("arith int16 (64, 128)", "arith", "int16", {}, "emit_fusion", (0.0, 0.0)),
    ("break bf16 (32, 48)", "break", "bfloat16", {"max_blocks": 32, "replicate_limit": 1024},
     "emit_stitched_fusion", (2.0 ** -7, 2.0 ** -12)),
    ("int break int8 (32, 48)", "int_break", "int8", {"max_blocks": 32, "replicate_limit": 1024},
     "emit_stitched_fusion", (0.0, 0.0)),
]
# single-phase compiles beside the main path: a softmax whose one plan
# block's slots (263,168 bytes) pass a block's shared memory, so they live
# in a per-block workspace region
FUSION_COMPILES = [("softmax (128, 512) max_blocks=1", "softmax", {"max_blocks": 1})]


def dtype_compile(module_name, dtype, opts, device):
    """One of DTYPE_COMPILES (or FUSION_COMPILES, in f32), compiled for ``device``."""
    import numpy as np

    from repro_torch.core import StitchOptions, compile_module, trace
    from repro_torch.core.ir import BFLOAT16

    dt = BFLOAT16 if dtype == "bfloat16" else np.dtype(dtype)
    if module_name == "softmax":
        module = trace(lambda b, x: b.softmax(x), ("x", (128, 512), dt))
    elif module_name == "arith":
        module = trace(arith, ("x", (64, 128), dt), ("y", (64, 128), dt))
    else:
        fn = softmax_transpose if module_name == "break" else int_break
        module = trace(fn, ("x", (32, 48), dt), ("g", (48,), dt))
    return module, compile_module(module, StitchOptions(jit_replay=False, **opts), device=device)


def ptxas_by_kernel(logs):
    """Registers and spill bytes of each kernel nvcc built, from its
    ``-Xptxas -v`` lines: {name: {"registers": n, "spill_stores": n, ...}}."""
    import re

    out, name = {}, None
    for log in logs.values():
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
            if m:
                # a generated kernel by its own name, not the C++ mangled one
                gen = re.search(r"stitch_[0-9a-f]{16}", m.group(1))
                name = gen.group(0) if gen else m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and name:
                out.setdefault(name, {}).update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def geometry(source):
    """The launch a single-phase kernel's header states: grid, threads and
    bytes of dynamic shared memory a block."""
    import re

    m = re.search(r"one launch of (\d+) blocks of (\d+) threads, (\d+) bytes of shared memory", source)
    return {"grid": int(m.group(1)), "threads": int(m.group(2)), "smem_bytes": int(m.group(3))}


def stitched_compile(module_name, opts, device):
    """One of STITCHED_COMPILES, compiled for ``device``."""
    import numpy as np

    from repro_torch.core import StitchOptions, compile_module, trace
    from repro_torch.graphs import ALL_GRAPHS

    if module_name == "break":
        module = trace(softmax_transpose, ("x", (32, 48), np.float32), ("g", (48,), np.float32))
    else:
        module = ALL_GRAPHS[module_name]()
    return compile_module(module, StitchOptions(jit_replay=False, **opts), device=device)

# (rtol, atol) of each full-width call.  The kernel and its plain version
# both compute in f32 and round once to the output dtype, so a bf16 output
# may differ by one bf16 ulp (at most 2**-7 of the value, hence rtol 1e-2)
# where the f32 values straddle a rounding boundary; atol only covers the
# f32 difference near 0.  Output scales at these shapes: softmax over
# 49,155 entries has a mean of 2.0e-5; causal attention over 2048 keys and
# decode over ~2,300 keys give |o| of a few 1e-2 on most rows; rmsnorm and
# the gate's weights are of order 1 and 1e-1.
FULL_TOL = {
    "stitched_rmsnorm": (1e-2, 1e-4),
    "stitched_softmax": (2e-5, 1e-9),
    "stitched_flash_attention": (1e-2, 1e-4),
    "stitched_decode_attention": (1e-2, 1e-4),
    "stitched_moe_gate": (2e-5, 1e-6),
}


def degenerate_mask(graph, root, feeds, out_shape):
    """Outputs whose value is amplified roundoff (see DEGENERATE_TOL)."""
    import numpy as np

    if graph != "Speech" or out_shape != (8, 80):
        return None
    x, w = feeds["frames"], feeds["mel"]
    B, T, F = x.shape
    mel = ((x * x).reshape(B * T, F) @ w).reshape(B, T, F)
    const = (mel < 1e-6).all(axis=1)
    return np.concatenate([const, const], axis=1)


def max_err(got, want, mask):
    """Largest |got - want| and whether it passes the stated tolerances."""
    import torch

    g, w = got.double(), want.double()
    bad = ~torch.isclose(g, w, rtol=TOL, atol=TOL)
    if mask is not None:
        m = torch.as_tensor(mask, device=g.device)
        loose = torch.isclose(g, w, rtol=DEGENERATE_TOL, atol=DEGENERATE_TOL)
        bad = torch.where(m, ~loose, bad)
    err = float((g - w).abs().max()) if g.numel() else 0.0
    return err, not bool(bad.any())


def time_ms(fn, calls):
    """Milliseconds per call: CUDA events around ``calls`` calls after warmup."""
    import torch

    for _ in range(min(WARMUP, calls)):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls


def work(kernel):
    """Bytes each launch must move (inputs read once, outputs written once)
    and the f32 operations it must do."""
    nbytes = sum(i.bytesize for i in kernel.inputs) + sum(r.bytesize for r in kernel.outputs)
    ops = 0
    for m in kernel.fusion.members:
        if m.opcode in ("elementwise", "select"):
            ops += m.num_elements
        elif m.opcode == "reduce":
            ops += m.operands[0].num_elements
        elif m.opcode == "dot":
            ops += 2 * m.num_elements * m.operands[0].shape[-1]
    return nbytes, ops


def device_events(fn, calls):
    """The device kernels of ``calls`` calls as torch.profiler records
    them: a list of (name, device microseconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_profile(fn, calls):
    """Device activity of ``calls`` calls as torch.profiler records it: the
    device kernels per call, and their device microseconds per call by
    kernel name."""
    events = device_events(fn, calls)
    by_name = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us / calls
    return len(events) / calls, by_name


#: profiles taken of one call before a launch count that disagrees fails
PROFILE_TRIES = 4


def profiled_launches(label, fn, want, total=None):
    """Hold the device kernels that torch.profiler sees in ``PROFILED_CALLS``
    calls of ``fn`` against a plan: ``want`` maps each generated kernel's
    name to its launches a call, and ``total``, where given, is every
    device kernel a call must run.  Returns (device kernels a call, device
    µs a call by kernel name) of the profile that agreed.  The profiler
    drops a run's events now and then (it once saw 0.35 kernels a call of a
    graph that runs 4): a profile that disagrees is taken again, up to
    ``PROFILE_TRIES`` times, and one that never agrees fails the run."""
    readings = []
    for _ in range(PROFILE_TRIES):
        events = device_events(fn, PROFILED_CALLS)
        seen = len(events) / PROFILED_CALLS
        got = {k: sum(1 for name, _ in events if k in name) / PROFILED_CALLS for k in want}
        if got == want and (total is None or seen == total):
            by_name = {}
            for name, us in events:
                by_name[name] = by_name.get(name, 0.0) + us / PROFILED_CALLS
            return seen, by_name
        readings.append((seen, got))
        print(f"{label}: profile {len(readings)} read {seen} device kernels a call, generated "
              f"{got}; the plan says {want}, total {total}: taken again")
    raise SystemExit(f"{label}: the profiler's device kernels a call disagree with the plan "
                     f"({PROFILE_TRIES} profiles): want {want}, total {total}; read {readings}")


# the __global__ functions of each hand-written kernel, as the profiler names
# them; a call's device time is the sum over all of them
DEVICE_KERNEL = {
    "stitched_rmsnorm": ("sx_rmsnorm_vec_kernel", "sx_rmsnorm_kernel"),
    "stitched_softmax": ("sx_softmax_kernel", "sx_softmax_cluster_kernel"),
    "stitched_flash_attention": ("sx_flash_kernel", "sx_flash_mma_kernel"),
    "stitched_decode_attention": ("sx_decode_split_kernel", "sx_decode_combine_kernel"),
    "stitched_moe_gate": ("sx_moe_gate_kernel",),
}


def device_us_of(kernel, by_name):
    """Device microseconds per call of a hand-written kernel's __global__s."""
    return sum(t for name, t in by_name.items() if any(g in name for g in DEVICE_KERNEL[kernel]))


def launchers(kernel, dtype, scalar=False, cluster=False):
    """The launchers one call of a kernel runs, each once: flash attention
    runs the tensor-core kernel in bf16 and f16 and the f32 kernel in f32, decode
    attention its split and combine kernels, RMSNorm its 16-byte kernel
    unless ``scalar`` (rows it cannot serve), softmax its cluster kernel
    where ``cluster`` (wide rows) and its row kernel else, the gate one."""
    import torch

    sfx = {torch.bfloat16: "bf16", torch.float16: "f16"}.get(dtype, "f32")
    if kernel == "stitched_flash_attention":
        return {f"sx_flash_mma_attention_{sfx}" if sfx != "f32" else "sx_flash_attention_f32": 1}
    if kernel == "stitched_decode_attention":
        return {f"sx_decode_split_{sfx}": 1, f"sx_decode_combine_{sfx}": 1}
    if kernel == "stitched_rmsnorm":
        return {f"sx_rmsnorm_{sfx}" if scalar else f"sx_rmsnorm_vec_{sfx}": 1}
    if kernel == "stitched_softmax":
        return {f"sx_softmax_cluster_{sfx}" if cluster else f"sx_softmax_{sfx}": 1}
    return {f"sx_{kernel.removeprefix('stitched_')}_{sfx}": 1}


def compare(got, want, tol):
    """Largest |got - want|, and whether shapes, dtypes and values agree at
    ``tol = (rtol, atol)`` (NaN only where the plain version has NaN)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        return float("inf"), False
    g, w = got.double(), want.double()
    rtol, atol = tol
    ok = bool(torch.isclose(g, w, rtol=rtol, atol=atol, equal_nan=True).all())
    both = ~(g.isnan() & w.isnan())
    return (float((g - w)[both].abs().max()) if bool(both.any()) else 0.0), ok


def compare_gate(logits, got, want, tol):
    """The gate's weights at ``tol``, and its indices: a pick may
    differ from the plain version's only where the plain probabilities of
    the two experts are within GATE_TIE.  Returns (error, ok, differing picks)."""
    from repro_torch.kernels.ref import softmax_ref

    (w, i), (w2, i2) = got, want
    err, ok = compare(w, w2, tol)
    if i.shape != i2.shape or i.dtype != i2.dtype:
        return err, False, -1
    p = softmax_ref(logits.float())
    differ = i != i2
    gap = (p.gather(1, i.long()) - p.gather(1, i2.long())).abs()[differ]
    ok = ok and (not bool(differ.any()) or float(gap.max()) <= GATE_TIE)
    return err, ok, int(differ.sum())


def full_width_calls(dev, rng, randn, wide, rows):
    """One call of each hand-written kernel at granite-moe-3b-a800m's full
    width (``GRANITE``): RMSNorm, flash and decode attention in ``wide``
    (bf16 or f16), the sampler's softmax and the gate's logits in ``rows``
    (f32, or f16), each with its plain version, its library call, and the
    bytes and operations of its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    name = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    g = GRANITE
    D, Hq, Hkv, d = g["head_dim"], g["heads"], g["kv_heads"], g["d_model"]
    full = []
    x, gamma = randn((8, 512, d), wide), randn((d,), wide)
    full.append(dict(
        kernel="stitched_rmsnorm", label=f"x{tuple(x.shape)} {name[wide]}", x=x, gamma=gamma,
        call=lambda: ops.rmsnorm(x, gamma, eps=g["norm_eps"]),
        plain=lambda: ref.rmsnorm_ref(x, gamma, g["norm_eps"]),
        library=(lambda: F.rms_norm(x, (d,), gamma, g["norm_eps"])) if hasattr(F, "rms_norm") else None,
        bytes=nbytes(x, gamma, x), ops=4 * x.numel(), peak=F32_OPS_PER_S, dtype=wide,
    ))
    lg = randn((16, g["vocab"]), rows)
    full.append(dict(
        kernel="stitched_softmax", label=f"logits{tuple(lg.shape)} {name[rows]}",
        call=lambda: ops.softmax(lg), plain=lambda: ref.softmax_ref(lg),
        library=lambda: torch.softmax(lg, dim=-1), bytes=nbytes(lg, lg), ops=4 * lg.numel(),
        peak=F32_OPS_PER_S, cluster=True, dtype=rows,
    ))
    S = 2048
    q, k, v = randn((1, Hq, S, D), wide), randn((1, Hkv, S, D), wide), randn((1, Hkv, S, D), wide)
    full.append(dict(
        kernel="stitched_flash_attention", label=f"q{tuple(q.shape)} kv{tuple(k.shape)} {name[wide]} causal",
        call=lambda: ops.attention(q, k, v, causal=True),
        plain=lambda: ref.attention_ref(q, k, v, causal=True),
        library=lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
        bytes=nbytes(q, k, v, q), ops=4 * Hq * D * S * (S + 1) // 2, peak=BF16_OPS_PER_S, dtype=wide,
    ))
    B, Sc = 16, 4096
    qd = randn((B, Hq, D), wide)
    kc, vc = randn((B, Hkv, Sc, D), wide), randn((B, Hkv, Sc, D), wide)
    lengths = torch.as_tensor(rng.randint(1, Sc + 1, size=B), dtype=torch.int32, device=dev)
    valid = int(lengths.sum())
    mask = (torch.arange(Sc, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    full.append(dict(
        kernel="stitched_decode_attention",
        label=f"q{tuple(qd.shape)} kv{tuple(kc.shape)} {name[wide]}, {valid} valid keys",
        call=lambda: ops.attention_decode(qd, kc, vc, lengths),
        plain=lambda: ref.decode_attention_ref(qd, kc, vc, lengths),
        library=lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True),
        # the keys these lengths make valid, read once: count what the data needs
        bytes=nbytes(qd, lengths, qd) + 2 * Hkv * D * kc.element_size() * valid,
        ops=4 * Hq * D * valid, peak=BF16_OPS_PER_S, dtype=wide,
    ))
    gl = randn((4096, g["experts"]), rows)
    top_k = g["top_k"]

    def gate_library():
        w, i = torch.topk(torch.softmax(gl.float(), dim=-1), top_k, dim=-1)
        return w / w.sum(dim=-1, keepdim=True), i

    full.append(dict(
        kernel="stitched_moe_gate", label=f"logits{tuple(gl.shape)} {name[rows]} top{top_k}",
        call=lambda: ops.moe_gate(gl, top_k), plain=lambda: ref.moe_gate_ref(gl, top_k),
        library=gate_library, logits=gl, dtype=rows,
        bytes=nbytes(gl) + gl.shape[0] * top_k * 8, ops=gl.numel() * (4 + top_k), peak=F32_OPS_PER_S,
    ))
    return full


def time_full(c):
    """A full-width call's numbers: CUDA-event ms, device ms, its plain
    version's ms, its library call's ms (events and device), and its bound."""
    ms = time_ms(c["call"], KERNEL_CALLS)
    device_us = device_us_of(c["kernel"], device_profile(c["call"], PROFILED_CALLS)[1])
    library_device_us = (sum(device_profile(c["library"], PROFILED_CALLS)[1].values())
                         if c["library"] else None)
    b_ms, o_ms = 1e3 * c["bytes"] / HBM_BYTES_PER_S, 1e3 * c["ops"] / c["peak"]
    return {
        "ms": ms, "plain_ms": time_ms(c["plain"], FULL_PLAIN_CALLS),
        # None where the profiler recorded no device time for it
        "device_ms": device_us / 1e3 if device_us else None,
        "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
        "library_ms": time_ms(c["library"], KERNEL_CALLS) if c["library"] else None,
        # None where there is no library call or the profiler recorded no device time
        "library_device_ms": library_device_us / 1e3 if library_device_us else None,
    }


def kernels_phase(dev):
    """Phase 6 (see the module docstring).  Returns the five hand-written
    kernels' entries of the kernels line and one row per call."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.stitched_attention import decode_splits
    from repro_torch.kernels.stitched_moe_gate import gate_grid

    kernels = ops.KERNELS
    rng = np.random.RandomState(0)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(shape, dtype):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev).to(dtype)

    # ---- the full-width calls: one per kernel -------------------------------------
    g = GRANITE
    full = full_width_calls(dev, rng, randn, bf16, f32)
    x, gamma, gl, d = full[0]["x"], full[0]["gamma"], full[4]["logits"], g["d_model"]
    for c in full:
        c["tol"] = FULL_TOL[c["kernel"]]

    # ---- the small shapes of tests/test_kernels.py ---------------------------------
    small = []

    def add(kernel, label, call, plain, tol, **extra):
        small.append(dict(kernel=kernel, label=label, call=call, plain=plain, tol=(tol, tol), **extra))

    for dtype, name in ((f32, "float32"), (bf16, "bfloat16")):
        for shape in [(8, 16), (4, 8, 32), (2, 3, 5, 64), (16, 128)]:
            t = randn(shape, dtype)
            add("stitched_softmax", f"{shape} {name}", lambda t=t: ops.softmax(t),
                lambda t=t: ref.softmax_ref(t), KERNEL_TOL[name], dtype=dtype)
        for shape in [(4, 32), (2, 8, 64), (3, 5, 128)]:
            t, gm = randn(shape, dtype), randn(shape[-1:], dtype)
            add("stitched_rmsnorm", f"{shape} {name}", lambda t=t, gm=gm: ops.rmsnorm(t, gm),
                lambda t=t, gm=gm: ref.rmsnorm_ref(t, gm), KERNEL_TOL[name], dtype=dtype)
    for br in (1, 2, 4, 8):
        t = randn((8, 24), f32)
        add("stitched_softmax", f"(8, 24) block_rows={br}", lambda t=t, br=br: ops.softmax(t, block_rows=br),
            lambda t=t: ref.softmax_ref(t), KERNEL_TOL["float32"])
    for (b, hq, hkv, s, dd) in [(1, 2, 2, 16, 8), (2, 4, 2, 32, 16), (1, 8, 1, 16, 8)]:
        for causal in (True, False):
            qs, ks, vs = randn((b, hq, s, dd), f32), randn((b, hkv, s, dd), f32), randn((b, hkv, s, dd), f32)
            add("stitched_flash_attention", f"{(b, hq, hkv, s, dd)} causal={causal}",
                lambda qs=qs, ks=ks, vs=vs, c=causal: ops.attention(qs, ks, vs, causal=c, block_q=8, block_k=8),
                lambda qs=qs, ks=ks, vs=vs, c=causal: ref.attention_ref(qs, ks, vs, causal=c),
                ATTENTION_TOL["float32"], dtype=f32)
    qs, ks, vs = randn((1, 2, 16, 8), bf16), randn((1, 2, 16, 8), bf16), randn((1, 2, 16, 8), bf16)
    add("stitched_flash_attention", "(1, 2, 2, 16, 8) bfloat16",
        lambda qs=qs, ks=ks, vs=vs: ops.attention(qs, ks, vs, causal=True, block_q=8, block_k=8),
        lambda qs=qs, ks=ks, vs=vs: ref.attention_ref(qs, ks, vs, causal=True),
        ATTENTION_TOL["bfloat16"], dtype=bf16)
    for (b, hq, hkv, s, dd) in [(2, 4, 2, 32, 8), (1, 8, 1, 64, 16), (3, 2, 2, 16, 8)]:
        qq, kk, vv = randn((b, hq, dd), f32), randn((b, hkv, s, dd), f32), randn((b, hkv, s, dd), f32)
        ln = torch.as_tensor(rng.randint(1, s + 1, size=b), dtype=torch.int32, device=dev)
        add("stitched_decode_attention", f"{(b, hq, hkv, s, dd)} lengths={ln.tolist()}",
            lambda qq=qq, kk=kk, vv=vv, ln=ln: ops.attention_decode(qq, kk, vv, ln, block_k=8),
            lambda qq=qq, kk=kk, vv=vv, ln=ln: ref.decode_attention_ref(qq, kk, vv, ln),
            ATTENTION_TOL["float32"], dtype=f32)
    # beyond the test file: the other head dims the kernels are built for,
    # at the default blocks (at D = 128 the flash K/V tiles take 128 KB of
    # shared memory), flash with block_q != block_k, and 16 and 32 rows per
    # block for the row kernels
    for dd in (32, 128):
        for dtype, name in ((f32, "float32"), (bf16, "bfloat16")):
            qs, ks, vs = randn((1, 4, 256, dd), dtype), randn((1, 2, 256, dd), dtype), randn((1, 2, 256, dd), dtype)
            add("stitched_flash_attention", f"(1, 4, 2, 256, {dd}) {name} causal default blocks",
                lambda qs=qs, ks=ks, vs=vs: ops.attention(qs, ks, vs, causal=True),
                lambda qs=qs, ks=ks, vs=vs: ref.attention_ref(qs, ks, vs, causal=True),
                ATTENTION_TOL[name], dtype=dtype)
            qq, kk, vv = randn((2, 4, dd), dtype), randn((2, 2, 512, dd), dtype), randn((2, 2, 512, dd), dtype)
            ln = torch.as_tensor(rng.randint(1, 513, size=2), dtype=torch.int32, device=dev)
            add("stitched_decode_attention", f"(2, 4, 2, 512, {dd}) {name} lengths={ln.tolist()}",
                lambda qq=qq, kk=kk, vv=vv, ln=ln: ops.attention_decode(qq, kk, vv, ln),
                lambda qq=qq, kk=kk, vv=vv, ln=ln: ref.decode_attention_ref(qq, kk, vv, ln),
                ATTENTION_TOL[name], dtype=dtype)
    for bq, bk, causal in ((8, 16, True), (16, 8, True), (8, 32, False)):
        qs, ks, vs = randn((1, 4, 64, 16), f32), randn((1, 2, 64, 16), f32), randn((1, 2, 64, 16), f32)
        add("stitched_flash_attention", f"(1, 4, 2, 64, 16) block_q={bq} block_k={bk} causal={causal}",
            lambda qs=qs, ks=ks, vs=vs, bq=bq, bk=bk, c=causal:
                ops.attention(qs, ks, vs, causal=c, block_q=bq, block_k=bk),
            lambda qs=qs, ks=ks, vs=vs, c=causal: ref.attention_ref(qs, ks, vs, causal=c),
            ATTENTION_TOL["float32"], dtype=f32)
    # the edges of the attention kernels' tiles and splits: bf16 flash at S =
    # 48 and 80 (not multiples of its 64-row tiles), D = 8 (padded to 16), 16
    # and 64, G = 8; bf16 decode at lengths 0 (NaN in both versions), 1,
    # split - 1, split, split + 1 and S, G = 1, 3 and 8, D = 64 and 128
    for s in (48, 80):
        for dd in (8, 16, 64):
            for causal in (True, False):
                qs, ks, vs = randn((1, 8, s, dd), bf16), randn((1, 1, s, dd), bf16), randn((1, 1, s, dd), bf16)
                add("stitched_flash_attention", f"(1, 8, 1, {s}, {dd}) bfloat16 causal={causal}",
                    lambda qs=qs, ks=ks, vs=vs, c=causal: ops.attention(qs, ks, vs, causal=c),
                    lambda qs=qs, ks=ks, vs=vs, c=causal: ref.attention_ref(qs, ks, vs, causal=c),
                    ATTENTION_TOL["bfloat16"], dtype=bf16)
    sd = 512
    split = decode_splits(sd)[0]
    edge_lengths = [0, 1, split - 1, split, split + 1, sd]
    for gg in (1, 3, 8):
        for dd in (64, 128):
            nb = len(edge_lengths)
            qq, kk, vv = randn((nb, 2 * gg, dd), bf16), randn((nb, 2, sd, dd), bf16), randn((nb, 2, sd, dd), bf16)
            ln = torch.tensor(edge_lengths, dtype=torch.int32, device=dev)
            add("stitched_decode_attention", f"({nb}, {2 * gg}, 2, {sd}, {dd}) bfloat16 lengths={edge_lengths}",
                lambda qq=qq, kk=kk, vv=vv, ln=ln: ops.attention_decode(qq, kk, vv, ln),
                lambda qq=qq, kk=kk, vv=vv, ln=ln: ref.decode_attention_ref(qq, kk, vv, ln),
                ATTENTION_TOL["bfloat16"], dtype=bf16)
    for br, shape in ((16, (64, 24)), (32, (64, 24)), (16, (32, 300))):
        t, gm = randn(shape, f32), randn(shape[-1:], f32)
        add("stitched_softmax", f"{shape} block_rows={br}", lambda t=t, br=br: ops.softmax(t, block_rows=br),
            lambda t=t: ref.softmax_ref(t), KERNEL_TOL["float32"])
        add("stitched_rmsnorm", f"{shape} block_rows={br}",
            lambda t=t, gm=gm, br=br: ops.rmsnorm(t, gm, block_rows=br),
            lambda t=t, gm=gm: ref.rmsnorm_ref(t, gm), KERNEL_TOL["float32"])
    gate_cases = [(16, 8, 2), (32, 40, 8), (8, 16, 1), (64, 64, 4)]
    gate_cases += [(32, g["experts"], kk) for kk in range(1, 9)]
    for (t, e, kk) in gate_cases:
        lt = randn((t, e), f32)
        add("stitched_moe_gate", f"T={t} E={e} k={kk}",
            lambda lt=lt, kk=kk: ops.moe_gate(lt, kk, block_tokens=8),
            lambda lt=lt, kk=kk: ref.moe_gate_ref(lt, kk), KERNEL_TOL["float32"], logits=lt)
    # where the redesigned gate and RMSNorm split: the gate's slots a lane
    # (E = 32/33, 64/65, 128, 256), a T that leaves its last block short,
    # and the rows of tests/test_torch_kernels.py whose softmax is NaN (a
    # NaN logit, a +inf logit, only -inf) beside finite rows, f32 and bf16;
    # RMSNorm's scalar kernel (bf16 d = 300, a view 2 bytes off 16, a row
    # past the 32 KB held in registers) and its 16-byte kernel at f32 d =
    # 1536 (two warps a row) and at the widest row held (bf16 d = 16,384)
    for e in (32, 33, 64, 65, 128, 256):
        lt = randn((64, e), f32)
        add("stitched_moe_gate", f"T=64 E={e} k=8",
            lambda lt=lt: ops.moe_gate(lt, 8), lambda lt=lt: ref.moe_gate_ref(lt, 8),
            KERNEL_TOL["float32"], logits=lt)
    lt = randn((4100, g["experts"]), f32)
    add("stitched_moe_gate", "T=4100 E=40 k=8 (last block 4 tokens short)",
        lambda lt=lt: ops.moe_gate(lt, 8), lambda lt=lt: ref.moe_gate_ref(lt, 8),
        KERNEL_TOL["float32"], logits=lt)
    for dtype, name in ((f32, "float32"), (bf16, "bfloat16")):
        for e, kk in ((8, 3), (40, 8)):
            lt = randn((8, e), f32)
            lt[1, 3], lt[3, e - 1], lt[5], lt[6, 2] = float("nan"), float("inf"), float("-inf"), float("-inf")
            lt = lt.to(dtype)
            add("stitched_moe_gate", f"T=8 E={e} k={kk} {name} NaN/inf rows",
                lambda lt=lt, kk=kk: ops.moe_gate(lt, kk), lambda lt=lt, kk=kk: ref.moe_gate_ref(lt, kk),
                KERNEL_TOL["float32"], logits=lt, dtype=dtype)
    t, gm = randn((64, 300), bf16), randn((300,), bf16)
    add("stitched_rmsnorm", "(64, 300) bfloat16 (scalar kernel)", lambda t=t, gm=gm: ops.rmsnorm(t, gm),
        lambda t=t, gm=gm: ref.rmsnorm_ref(t, gm), KERNEL_TOL["bfloat16"], dtype=bf16, scalar=True)
    t, gm = randn((64 * 1536 + 1,), bf16)[1:].view(64, 1536), randn((1536,), bf16)
    add("stitched_rmsnorm", "(64, 1536) bfloat16 view 2 bytes off 16 (scalar kernel)",
        lambda t=t, gm=gm: ops.rmsnorm(t, gm), lambda t=t, gm=gm: ref.rmsnorm_ref(t, gm),
        KERNEL_TOL["bfloat16"], dtype=bf16, scalar=True)
    t, gm = randn((8, 16392), bf16), randn((16392,), bf16)
    add("stitched_rmsnorm", "(8, 16392) bfloat16 past the held width (scalar kernel)",
        lambda t=t, gm=gm: ops.rmsnorm(t, gm), lambda t=t, gm=gm: ref.rmsnorm_ref(t, gm),
        KERNEL_TOL["bfloat16"], dtype=bf16, scalar=True)
    for shape, dtype, name in (((512, 1536), f32, "float32"), ((8, 16384), bf16, "bfloat16")):
        t, gm = randn(shape, dtype), randn(shape[-1:], dtype)
        add("stitched_rmsnorm", f"{shape} {name}", lambda t=t, gm=gm: ops.rmsnorm(t, gm),
            lambda t=t, gm=gm: ref.rmsnorm_ref(t, gm), KERNEL_TOL[name], dtype=dtype)

    # where softmax's cluster kernel splits: rows off 16 bytes, the widths
    # around its threshold and past what a cluster holds, bf16 at full
    # width, one block's slice wholly -inf, rows NaN across
    vocab = g["vocab"]
    eighth = -(-vocab // 8)
    for shape, dtype, name, cluster in (
            ((5, vocab), f32, "float32", True), ((3, 10001), f32, "float32", True),
            ((4, 4095), f32, "float32", False), ((4, 4096), f32, "float32", True),
            ((4, 4097), f32, "float32", True), ((2, 131072), f32, "float32", True),
            ((2, 131073), f32, "float32", False), ((16, vocab), bf16, "bfloat16", True)):
        t = randn(shape, dtype)
        add("stitched_softmax", f"{shape} {name}", lambda t=t: ops.softmax(t),
            lambda t=t: ref.softmax_ref(t), KERNEL_TOL[name], dtype=dtype, cluster=cluster)
    for dtype, name in ((f32, "float32"), (bf16, "bfloat16")):
        t = randn((8, vocab), f32)
        t[0, :eighth] = float("-inf")                 # block 0's slice
        t[1, eighth:2 * eighth] = float("-inf")       # block 1's slice
        t[2, 7 * eighth:] = float("-inf")             # the last, shorter slice
        t[3, 5], t[4, 9], t[5] = float("nan"), float("inf"), float("-inf")
        t = t.to(dtype)
        add("stitched_softmax", f"(8, {vocab}) {name} -inf slices, NaN/+inf/-inf rows",
            lambda t=t: ops.softmax(t), lambda t=t: ref.softmax_ref(t), KERNEL_TOL[name],
            dtype=dtype, cluster=True)

    # ---- the main path: one call of each kernel at full width -----------------------
    def expect(c):
        """The launches of one call of ``c``: each launcher's count."""
        return launchers(c["kernel"], c.get("dtype"), c.get("scalar", False), c.get("cluster", False))

    for kern in kernels.values():
        kern.launches, kern.by_symbol = 0, {}
    outs = [c["call"]() for c in full]
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in kernels.items()}
    want = {c["kernel"]: sum(expect(c).values()) for c in full}
    if sorted(want) != sorted(kernels) or launches != want:
        raise SystemExit(f"kernels: launches at full width {launches}, expected {want}")
    for c in full:
        if kernels[c["kernel"]].by_symbol != expect(c):
            raise SystemExit(f"{c['kernel']}: launchers {kernels[c['kernel']].by_symbol}, "
                             f"expected {expect(c)}")
    for c, out in zip(full, outs, strict=True):
        c["out"], c["full_width"] = out, True
    for c in small:
        kern = kernels[c["kernel"]]
        before, by = kern.launches, dict(kern.by_symbol)
        c["out"] = c["call"]()
        ran = {k: n - by.get(k, 0) for k, n in kern.by_symbol.items() if n != by.get(k, 0)}
        if kern.launches - before != sum(expect(c).values()) or ran != expect(c):
            raise SystemExit(f"{c['kernel']} {c['label']}: launched {ran}, expected {expect(c)}")
    torch.cuda.synchronize()
    gate_block, gate_blocks = gate_grid(gl.shape[0], 256)
    if gate_blocks < 132:
        raise SystemExit(f"stitched_moe_gate: {gate_blocks} blocks at full width, expected >= 132")
    print(f"kernels: main path {sum(launches.values())} launches at full width ({launches}); "
          f"{len(small)} small calls, each through its expected launchers; the gate's grid "
          f"{gate_blocks} blocks of {gate_block} tokens")

    # ---- right: every call against its plain version on the same inputs -----------
    rows, gate_differ = [], 0
    for c in full + small:
        want = c["plain"]()
        if "logits" in c:
            err, ok, n = compare_gate(c["logits"], c["out"], want, c["tol"])
            gate_differ += max(n, 0)
        else:
            err, ok = compare(c["out"], want, c["tol"])
        if not ok:
            raise SystemExit(f"{c['kernel']} {c['label']}: kernel vs plain {err:.3e} over "
                             f"(rtol, atol)={c['tol']}")
        mag = (want[0] if isinstance(want, tuple) else want).float().abs().nan_to_num()
        c["err"], c["out_scale"], c["out_median"] = err, float(mag.max()), float(mag.median())
        rows.append({"kernel": c["kernel"], "shape": c["label"], "full_width": "full_width" in c,
                     "max_abs_err": err, "max_abs_out": c["out_scale"],
                     "median_abs_out": c["out_median"], "tolerance": list(c["tol"])})
    for c in full:
        results = c["out"] if isinstance(c["out"], tuple) else (c["out"],)
        if not all(bool(torch.isfinite(o.float()).all()) for o in results):
            raise SystemExit(f"{c['kernel']} {c['label']}: non-finite output")
    print(f"right: {len(full) + len(small)} calls of the 5 hand-written kernels agree with their "
          f"plain versions; MoE gate picks that differ between near-equal probabilities: {gate_differ}")

    # ---- numbers at full width -------------------------------------------------------
    def cold_l2(c):
        """RMSNorm's and F.rms_norm's device ms over a rotation of
        COLD_ROTATION inputs of the full-width shape (8 x 12.6 MB, twice the
        50 MB L2), so each call finds its x in device memory, not in L2."""
        gen = torch.Generator(device=dev).manual_seed(1)
        xs = [torch.randn(x.shape, generator=gen, device=dev).to(bf16) for _ in range(COLD_ROTATION)]
        turn = itertools.count()
        kern_us = device_us_of("stitched_rmsnorm", device_profile(
            lambda: ops.rmsnorm(xs[next(turn) % COLD_ROTATION], gamma, eps=g["norm_eps"]),
            PROFILED_CALLS)[1])
        lib_us = (sum(device_profile(
            lambda: F.rms_norm(xs[next(turn) % COLD_ROTATION], (d,), gamma, g["norm_eps"]),
            PROFILED_CALLS)[1].values()) if c["library"] else 0.0)
        print(f"kernel stitched_rmsnorm {c['label']} over {COLD_ROTATION} inputs (cold L2): "
              f"device_ms={kern_us / 1e3 if kern_us else 'not measured'} "
              f"library_device_ms={lib_us / 1e3 if lib_us else 'not measured'}")
        return {"cold_device_ms": kern_us / 1e3 if kern_us else None,
                "library_cold_device_ms": lib_us / 1e3 if lib_us else None}

    entries = []
    for c in full:
        kern = kernels[c["kernel"]]
        t = time_full(c)
        entry = {
            "name": kern.name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{kern.source.path.name}",
            "replaces": kern.replaces, "launches": launches[kern.name],
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["kernel"] == kern.name),
            **t,
            "shape": c["label"], "tolerance": list(c["tol"]),
            "full_width_err": c["err"], "max_abs_out": c["out_scale"],
            "median_abs_out": c["out_median"],
        }
        if kern.name == "stitched_rmsnorm":
            entry.update(cold_l2(c))
        entries.append(entry)
        print(
            f"kernel {kern.name} {c['label']}: launches={entry['launches']} ms={t['ms']:.4f} "
            f"device_ms={entry['device_ms'] or 'not measured'} plain_ms={t['plain_ms']:.4f} "
            f"library_ms={t['library_ms'] if t['library_ms'] is not None else 'none'} "
            f"library_device_ms={entry['library_device_ms'] or 'not measured'} "
            f"bound_ms={entry['bound_ms']:.5f} ({entry['bound_by']}) err={entry['max_abs_err']:.2e} "
            f"full_width_err={c['err']:.3e} |out| max={c['out_scale']:.3e} "
            f"median={c['out_median']:.3e} (rtol, atol)={c['tol']}"
        )
    return entries, rows


# ---------------------------------------------------------------------------
# Phases 7-11: replay, loops, verify, autotune, f16 and the emission faults
# ---------------------------------------------------------------------------

# the fault modules of tests/test_torch_codegen.py, built with the port's own
# GraphBuilder: a concat of composed reshapes (one kernel of 6 members over 4
# plan blocks) and a stitched kernel whose SHARE member reads its slot
# transposed (it writes through the workspace's staging region)
def concat_module():
    from repro_torch.core import GraphBuilder

    b = GraphBuilder("concat_pieces")
    x = b.parameter("x", (64, 128), "float32")
    s, m = b.reduce(x, (1,), "sum"), b.reduce(x, (1,), "max")
    b.exp(b.concat([b.reshape(s, (64, 1)), b.reshape(m, (64, 1))], 1))
    return b.module


def share_module():
    from repro_torch.core import GraphBuilder

    b = GraphBuilder("share_transposed")
    x = b.parameter("x", (32, 32), "float32")
    a = b.tanh(b.transpose(b.exp(x), (1, 0)))
    m = b.transpose(a, (1, 0)) + b.neg(a)
    b.exp(m) + m * m
    return b.module


FAULT_MODULES = {"concat": concat_module, "share": share_module}
LOOPS = ("RNNScan", "DecodeLoop", "ReverseScan")
LINT_MAX_BLOCKS = 64          # what python -m repro_torch.lint compiles under
AUTOTUNE_ROUNDS = 3           # the cost planner's autotuned compiles of each graph

# f16 kernel vs plain version at full width: both compute in f32 and round
# once to f16, so an output may differ by one f16 ulp (2**-11 of the value,
# hence rtol 1e-3) where the f32 values straddle a rounding boundary; softmax
# outputs near 2e-5 are f16 subnormals, whose ulp is 2**-24 (atol 1e-7)
F16_TOL = {
    "stitched_rmsnorm": (1e-3, 1e-4),
    "stitched_softmax": (1e-3, 1e-7),
    "stitched_flash_attention": (2e-3, 1e-4),
    "stitched_decode_attention": (2e-3, 1e-4),
    "stitched_moe_gate": (2e-5, 1e-6),
}


def sources_of(compiled):
    """The CUDA sources of a compile and of its loop bodies' compiles."""
    out = [compiled.cuda_source] if "__global__" in compiled.cuda_source else []
    for instr in compiled.executable.module.instructions:
        if instr.opcode == "call":
            out += sources_of(instr.attrs["compiled_body"])
    return out


def programs_of(compiled):
    """Every generated kernel a compile launches, loop bodies included,
    each once: {id: program}."""
    out = {id(k.fn): k.fn for k in compiled.kernels}
    for instr in compiled.executable.module.instructions:
        if instr.opcode == "call":
            out.update(programs_of(instr.attrs["compiled_body"]))
    return out


def planned_launches(compiled):
    """Generated-kernel launches one call makes: the fused kernels, and each
    loop's body kernels once an iteration."""
    n = compiled.stats.stitched_kernels
    for instr in compiled.executable.module.instructions:
        if instr.opcode == "call":
            n += int(instr.attrs["trip_count"]) * planned_launches(instr.attrs["compiled_body"])
    return n


def same(a, b):
    """Bit for bit, NaN where NaN."""
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


def planned_by_program(compiled):
    """Generated-kernel launches one call makes, by kernel name: each fused
    kernel once, each loop's body kernels once an iteration."""
    out = {}
    for k in compiled.executable.kernels.values():
        out[k.fn.name] = out.get(k.fn.name, 0) + 1
    for instr in compiled.executable.module.instructions:
        if instr.opcode == "call":
            for name, n in planned_by_program(instr.attrs["compiled_body"]).items():
                out[name] = out.get(name, 0) + int(instr.attrs["trip_count"]) * n
    return out


def replay_ticks(compiled):
    """The launches a replay adds to the counters, by kernel name: what the
    plan recorded at its capture (bookkeeping, not a measurement)."""
    out = {}
    for p, n in compiled.executable.execution_plan._graph.ticks:
        out[p.name] = out.get(p.name, 0) + n
    return out


def replay_phase(dev, graphs, eager_out):
    """Phase 7: every graph replayed through its CUDA graph.  A default call
    takes the path its plan chose (``replay_mode``: eager where a replay
    would dispatch more); ``jit_execute`` replays every graph, so the
    replay is held and timed on all ten.  Launches per replayed call are
    the profiler's: each generated kernel as often as the plan says, and
    every device kernel of the eager call plus one a copy group."""
    import torch

    from repro_torch.core import compile_module

    rows = []
    for name, (module, eager, feeds, dfeeds) in graphs.items():
        rp = compile_module(module, device=dev)          # the defaults: jit_replay=True
        s, ex = rp.stats, rp.executable
        mode = "graph" if s.traced_dispatches_per_call <= s.eager_dispatches_per_call else "eager"
        if s.replay_mode != mode or ex.replay_mode != mode:
            raise SystemExit(f"{name}: replay mode {s.replay_mode}, the dispatch counts "
                             f"({s.eager_dispatches_per_call} eager, {s.traced_dispatches_per_call} "
                             f"replayed) say {mode}")
        st0 = ex.launch_stats()
        rp(dfeeds)
        st1 = ex.launch_stats()
        took = "graph" if st1.traced_calls > st0.traced_calls else "eager"
        if took != mode or st1.traced_calls + st1.eager_calls != st0.traced_calls + st0.eager_calls + 1:
            raise SystemExit(f"{name}: a default call took the {took} path, its mode is {mode}")
        first = ex.jit_execute(dfeeds)                   # captured at the first replay
        second = ex.jit_execute(dfeeds)
        torch.cuda.synchronize()
        plan = planned_by_program(rp)
        if sum(plan.values()) != planned_launches(rp) or replay_ticks(rp) != plan:
            raise SystemExit(f"{name}: the capture recorded {replay_ticks(rp)}, the plan "
                             f"launches {plan}")
        ref = eager_out[name]
        bitwise = all(same(first[k], ref[k]) and same(second[k], ref[k]) for k in ref)
        held = []
        if not bitwise:
            # only a library dot may round differently under capture
            held = [i.name for i in ex.plan.standalone if i.is_library_call]
            for k in ref:
                for out in (first, second):
                    err, ok = max_err(out[k], ref[k], degenerate_mask(name, k, feeds, tuple(ref[k].shape)))
                    if not held or not ok:
                        raise SystemExit(f"{name}:{k}: replay vs eager {err:.3e}, library dots {held}")
        seg = ex.execution_plan._graph
        # the feeds' copies into the graph and the roots' out of it: the
        # small tensors' batched by dtype, a dispatch a group
        copied = len(seg.feed_slots) + len(seg.out_slots)
        copies = len(seg.in_groups) + len(seg.out_groups)
        eager_us = 1e3 * time_ms(lambda c=eager, f=dfeeds: c(f), CALLS)
        replay_us = 1e3 * time_ms(lambda x=ex, f=dfeeds: x.jit_execute(f), CALLS)
        e_seen, e_by = profiled_launches(f"{name} eager", lambda c=eager, f=dfeeds: c(f), plan)
        r_seen, r_by = profiled_launches(f"{name} replayed", lambda x=ex, f=dfeeds: x.jit_execute(f),
                                         plan, total=e_seen + copies)
        e_dev, r_dev = sum(e_by.values()), sum(r_by.values())
        row = {
            "graph": name, "replay_mode": mode, "bitwise": bitwise, "held_at_tol": held,
            "launches_per_call": sum(plan.values()), "copies_per_call": copies,
            "tensors_copied": copied,
            "eager_dispatches_per_call": s.eager_dispatches_per_call,
            "traced_dispatches_per_call": s.traced_dispatches_per_call,
            "eager_us_per_call": eager_us, "replay_us_per_call": replay_us,
            "eager_device_us_per_call": e_dev, "replay_device_us_per_call": r_dev,
            "eager_idle_share": 1.0 - e_dev / eager_us, "replay_idle_share": 1.0 - r_dev / replay_us,
            "eager_device_kernels": e_seen, "replay_device_kernels": r_seen,
        }
        rows.append(row)
        print(f"replay {name}: mode={mode} (dispatches eager {s.eager_dispatches_per_call}, "
              f"replayed {s.traced_dispatches_per_call}); "
              f"{'bitwise' if bitwise else 'held at TOL (library dots ' + ', '.join(held) + ')'} "
              f"vs eager over 2 calls; profiler: {sum(plan.values())} generated launches a "
              f"replayed call as planned, device kernels eager={e_seen} replay={r_seen} "
              f"(eager + {copies} copies, {copied} tensors) "
              f"us_per_call eager={eager_us:.1f} replay={replay_us:.1f} "
              f"device_us eager={e_dev:.2f} replay={r_dev:.2f} "
              f"idle_share eager={row['eager_idle_share']:.3f} replay={row['replay_idle_share']:.3f}")
    return rows


def loops_phase(dev):
    """Phase 8: the loop modules on the card, eager and replayed."""
    import numpy as np
    import torch

    from repro_torch.core import StitchOptions, compile_module, reference_execute
    from repro_torch.core.ir import apply_op
    from repro_torch.graphs import LOOP_GRAPHS, rnn_graph

    rows = []
    for name in LOOPS:
        module = LOOP_GRAPHS[name]()
        rng = np.random.RandomState(2)
        feeds = {p.name: torch.as_tensor((rng.randn(*p.shape) * 0.3).astype(np.float32), device=dev)
                 for p in module.parameters}
        eager = compile_module(module, StitchOptions(jit_replay=False), device=dev)
        rp = compile_module(module, device=dev)
        plain = reference_execute(module, feeds, device=dev)
        progs = {**programs_of(eager), **programs_of(rp)}
        for p in progs.values():
            p.launches = 0
        out_e = eager(feeds)
        torch.cuda.synchronize()
        n_e = sum(p.launches for p in progs.values())
        out_r, out_r2 = rp(feeds), rp(feeds)
        for p in progs.values():
            p.launches = 0
        rp(feeds)
        torch.cuda.synchronize()
        n_r = sum(p.launches for p in progs.values())
        want = planned_launches(eager)
        plan = planned_by_program(rp)
        if rp.stats.replay_mode != "graph" or n_e != want or n_r != want or replay_ticks(rp) != plan:
            raise SystemExit(f"{name}: mode {rp.stats.replay_mode}, launches eager {n_e}, "
                             f"replayed {n_r} (bookkeeping), planned {want}")
        err = 0.0
        for k in plain:
            for out in (out_e, out_r, out_r2):
                e, ok = max_err(out[k], plain[k], None)
                err = max(err, e)
                if not ok or not bool(torch.isfinite(out[k]).all()):
                    raise SystemExit(f"{name}:{k}: vs plain path {e:.3e}")
        bitwise = all(same(out_r[k], out_e[k]) and same(out_r2[k], out_e[k]) for k in plain)
        if name == "RNNScan":
            # the unrolled RNN graph's last hidden state, op by op on the card
            unrolled = rnn_graph()
            uf = {k: feeds[k] for k in ("Wx", "Wh", "b", "h0")}
            uf.update({f"x{t}": feeds["xs"][t] for t in range(6)})
            uf["Wo"] = torch.zeros((32, 8), device=dev)
            vals = {}
            for instr in unrolled.instructions:
                vals[instr.id] = (uf[instr.name] if instr.opcode == "parameter" else
                                  apply_op(instr, *[vals[o.id] for o in instr.operands], device=dev))
            wo = next(i for i in unrolled.instructions if i.name == "Wo")
            h_unrolled = vals[wo.users[0].operands[0].id]
            final = out_r[module.roots[0].name]
            e, ok = max_err(final, h_unrolled, None)
            if not ok:
                raise SystemExit(f"RNNScan: final state vs the unrolled RNN graph's {e:.3e}")
            err = max(err, e)
        eager_us = 1e3 * time_ms(lambda c=eager, f=feeds: c(f), CALLS)
        replay_us = 1e3 * time_ms(lambda c=rp, f=feeds: c(f), CALLS)
        seg = rp.executable.execution_plan._graph
        e_seen, e_by = profiled_launches(f"{name} eager", lambda c=eager, f=feeds: c(f), plan)
        _, r_by = profiled_launches(f"{name} replayed", lambda c=rp, f=feeds: c(f), plan,
                                    total=e_seen + len(seg.in_groups) + len(seg.out_groups))
        e_dev, r_dev = sum(e_by.values()), sum(r_by.values())
        s = rp.stats
        rows.append({"module": name, "launches_per_call": want, "bitwise_replay_vs_eager": bitwise,
                     "max_abs_err": err, "loop_calls": s.loop_calls, "sub_compiles": s.sub_compiles,
                     "sub_kernels": s.sub_kernels, "eager_us_per_call": eager_us,
                     "replay_us_per_call": replay_us, "eager_device_us_per_call": e_dev,
                     "replay_device_us_per_call": r_dev})
        print(f"loop {name}: {want} launches a call eager and replayed (the profiler's), vs "
              f"plain path err={err:.2e}"
              f"{' (and the unrolled RNN graph)' if name == 'RNNScan' else ''}, replay "
              f"{'bitwise' if bitwise else 'within TOL'} vs eager; us_per_call eager={eager_us:.1f} "
              f"replay={replay_us:.1f} device_us eager={e_dev:.2f} replay={r_dev:.2f}")
    return rows


def verify_phase():
    """Phase 9: ``python -m repro_torch.lint`` on the card: the ten graphs
    under verify="strict" in both planners."""
    from repro_torch import lint

    t0 = time.perf_counter()
    rc = lint.main([])
    if rc != 0:
        raise SystemExit(f"repro_torch.lint exited {rc}")
    print(f"verify: repro_torch.lint clean on the card in {time.perf_counter() - t0:.1f} s")


def plan_shape(stats):
    return sorted((r.num_ops, r.blocks, r.num_phases) for r in stats.reports)


def autotune_phase(dev, graphs):
    """Phase 10: the ten graphs compiled with autotune=True, in each
    planner, into a fresh store under build/ and compiled again.  Under the
    greedy planner the plan does not depend on costs, so the second compile
    must take no new measurement.  The cost planner re-plans from what it
    measured and measures the kernels it newly commits: its compiles are
    reported, three of them.  In both, a compile measures only kernels the
    store does not hold, and the last compile's outputs agree with
    reference_execute."""
    import torch

    from repro_torch.core import StitchOptions, compile_module, reference_execute
    from repro_torch.core.latency import TPU_V5E
    from repro_torch.core.measure import MeasuredCostStore, device_fingerprint
    from repro_torch.graphs import ALL_GRAPHS

    fp = device_fingerprint(TPU_V5E, dev)
    rows = []
    for planner, rounds in (("greedy", 2), ("cost", AUTOTUNE_ROUNDS)):
        path = os.path.join(HERE, "build", "repro_torch", f"autotune_{planner}.json")
        if os.path.exists(path):
            os.remove(path)
        store = MeasuredCostStore(path, device_fp=fp)
        opts = StitchOptions(planner=planner, autotune=True, tuning_store_path=path,
                             jit_replay=False)
        default = StitchOptions(planner=planner, jit_replay=False)
        for name, (module, _, feeds, dfeeds) in graphs.items():
            base = compile_module(ALL_GRAPHS[name](), default, device="cpu")
            compiles = []
            for _ in range(rounds):
                held = len(store)
                c = compile_module(ALL_GRAPHS[name](), opts, device=dev, measured_store=store)
                if len(store) - held != c.stats.measurements_taken:
                    raise SystemExit(f"{name} [{planner}]: measured a kernel the store holds")
                compiles.append(c)
            store.save()
            if planner == "greedy" and compiles[1].stats.measurements_taken:
                raise SystemExit(f"{name} [greedy]: the warm compile took "
                                 f"{compiles[1].stats.measurements_taken} new measurements")
            last = compiles[-1]
            want = reference_execute(last.executable.module, dfeeds, device=dev)
            got = last(dfeeds)
            for k, w in want.items():
                e, ok = max_err(got[k], w, degenerate_mask(name, k, feeds, tuple(w.shape)))
                if not ok:
                    raise SystemExit(f"{name}:{k} [{planner}]: autotuned plan vs "
                                     f"reference_execute {e:.3e}")
            torch.cuda.synchronize()
            row = {
                "graph": name, "planner": planner,
                "measurements": [c.stats.measurements_taken for c in compiles],
                "measured_hits": [c.stats.measured_hits for c in compiles],
                "model_error_pct": compiles[0].stats.model_error_pct,
                "fused_kernels": [c.stats.stitched_kernels for c in compiles],
                "default_fused_kernels": base.stats.stitched_kernels,
                "plan_changed": [plan_shape(c.stats) != plan_shape(base.stats) for c in compiles],
                "measured_us": [[r.measured_cost_s * 1e6 if r.measured_cost_s else None
                                 for r in c.stats.reports] for c in compiles],
                "model_us": [[r.model_cost_s * 1e6 if r.model_cost_s else None
                              for r in c.stats.reports] for c in compiles],
            }
            rows.append(row)
            err = row["model_error_pct"]
            print(f"autotune {name} [{planner}]: measurements per compile {row['measurements']}, "
                  f"store hits {row['measured_hits']}, model_error_pct="
                  f"{f'{err:.1f}' if err is not None else 'none'}, fused kernels "
                  f"{row['fused_kernels']} (default {row['default_fused_kernels']}), plan changed "
                  f"from the default {row['plan_changed']}")
        print(f"autotune [{planner}]: store {os.path.relpath(path, HERE)}, {len(store)} rows keyed "
              f"by device fingerprint {fp}")
    return rows


def f16_phase(dev):
    """Phase 11a: the five hand-written kernels in f16 at granite-moe-3b-a800m's
    full width (``full_width_calls``, every input f16), each once with the
    counters read, held against its plain version, and timed beside it and
    its library call."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    kernels = ops.KERNELS
    rng = np.random.RandomState(3)
    f16 = torch.float16

    def randn(shape, dtype):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev).to(dtype)

    calls = full_width_calls(dev, rng, randn, f16, f16)
    for kern in kernels.values():
        kern.launches, kern.by_symbol = 0, {}
    outs = [c["call"]() for c in calls]
    torch.cuda.synchronize()
    for c, out in zip(calls, outs, strict=True):
        kern = kernels[c["kernel"]]
        expect = launchers(c["kernel"], f16, cluster=c.get("cluster", False))
        if kern.by_symbol != expect:
            raise SystemExit(f"{c['kernel']} f16: launchers {kern.by_symbol}, expected {expect}")
        want = c["plain"]()
        tol = F16_TOL[c["kernel"]]
        if "logits" in c:
            err, ok, _ = compare_gate(c["logits"], out, want, tol)
        else:
            err, ok = compare(out, want, tol)
        results = out if isinstance(out, tuple) else (out,)
        if not ok or not all(bool(torch.isfinite(o.float()).all()) for o in results):
            raise SystemExit(f"{c['kernel']} {c['label']}: kernel vs plain {err:.3e} over {tol}")
        c["err"], c["tol"] = err, tol
    print(f"f16: the 5 hand-written kernels at full width, one call each through their f16 "
          f"launchers ({', '.join(sorted(s for kk in kernels.values() for s in kk.by_symbol))}), "
          "each within its limit of its plain version")
    out = {}
    for c in calls:
        name = c["kernel"]
        t = time_full(c)
        out[name] = {f"f16_{k}": v for k, v in t.items() if k != "bound_by"}
        out[name].update({
            "f16_shape": c["label"], "f16_max_abs_err": c["err"], "f16_tolerance": list(c["tol"]),
            "f16_launches": sum(launchers(name, f16, cluster=c.get("cluster", False)).values()),
        })
        print(f"kernel {name} {c['label']}: ms={t['ms']:.4f} "
              f"device_ms={t['device_ms'] or 'not measured'} plain_ms={t['plain_ms']:.4f} "
              f"library_ms={t['library_ms'] if t['library_ms'] is not None else 'none'} "
              f"library_device_ms={t['library_device_ms'] or 'not measured'} "
              f"bound_ms={t['bound_ms']:.5f} err={c['err']:.2e} (rtol, atol)={c['tol']}")
    return out


def faults_phase(dev):
    """Phase 11b: the modules that reached the two emission limits, compiled
    for the card: one launch each, the kernel against its plain version on
    the inputs the call gave it, the outputs against reference_execute."""
    import numpy as np
    import torch

    from repro_torch.core import StitchOptions, compile_module, reference_execute

    rows = []
    for name, build in FAULT_MODULES.items():
        module = build()
        compiled = compile_module(module, StitchOptions(jit_replay=False), device=dev)
        (kernel,) = compiled.kernels
        rng = np.random.RandomState(4)
        feeds = {p.name: torch.as_tensor((rng.randn(*p.shape) * 0.1).astype(np.float32), device=dev)
                 for p in module.parameters}
        inputs = []

        def record(*a, device, _launch=kernel.fn.launch):
            inputs.append([t.clone() for t in a])
            return _launch(*a, device=device)

        kernel.fn.launch, kernel.fn.launches = record, 0
        got = compiled(feeds)
        torch.cuda.synchronize()
        del kernel.fn.launch
        if kernel.fn.launches != 1:
            raise SystemExit(f"{name}: {kernel.fn.launches} launches, expected 1")
        err = 0.0
        for g, w in zip(kernel.fn.launch(*inputs[0], device=dev), kernel.fn.plain(*inputs[0], device=dev),
                        strict=True):
            e, ok = max_err(g, w, None)
            err = max(err, e)
            if not ok:
                raise SystemExit(f"{name} {kernel.fn.name}: kernel vs plain {e:.3e}")
        for k, w in reference_execute(module, feeds, device=dev).items():
            e, ok = max_err(got[k], w, None)
            err = max(err, e)
            if not ok:
                raise SystemExit(f"{name}:{k}: vs reference_execute {e:.3e}")
        r = compiled.stats.reports[0]
        rows.append({"module": name, "kernel": kernel.fn.name, "emitter": kernel.fn.emitter,
                     "members": r.num_ops, "blocks": r.blocks, "phases": r.num_phases,
                     "workspace_bytes": kernel.fn.workspace_bytes, "max_abs_err": err})
        print(f"fault module {name}: {kernel.fn.emitter} {kernel.fn.name}, {r.num_ops} members, "
              f"{r.blocks} plan blocks, {r.num_phases} phases, one launch, vs plain and "
              f"reference_execute err={err:.2e}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number as JSON here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from repro_torch.core import StitchOptions, compile_module, cuda_build, reference_execute
    from repro_torch.core.codegen import REPLACES
    from repro_torch.graphs import ALL_GRAPHS, LOOP_GRAPHS, random_feeds
    from repro_torch.kernels.cuda import SOURCES as HAND_SOURCES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. device -----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")

    # ---- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    sources = [compile_module(g(), device="cpu").cuda_source for g in ALL_GRAPHS.values()]
    extra = [stitched_compile(name, opts, "cpu").cuda_source for _, name, opts, _ in STITCHED_COMPILES]
    extra += [dtype_compile(name, dt, opts, "cpu")[1].cuda_source
              for _, name, dt, opts, _, _ in DTYPE_COMPILES]
    extra += [dtype_compile(name, "float32", opts, "cpu")[1].cuda_source for _, name, opts in FUSION_COMPILES]
    # phases 8-11: the loops' bodies, the greedy plans, the lint's compiles
    # in both planners, the fault modules
    for name in LOOPS:
        extra += sources_of(compile_module(LOOP_GRAPHS[name](), device="cpu"))
    for g in ALL_GRAPHS.values():
        extra += sources_of(compile_module(g(), StitchOptions(planner="greedy"), device="cpu"))
        for planner in ("cost", "greedy"):
            lint_opts = StitchOptions(max_blocks=LINT_MAX_BLOCKS, planner=planner)
            extra += sources_of(compile_module(g(), lint_opts, device="cpu"))
    extra += [compile_module(build(), device="cpu").cuda_source for build in FAULT_MODULES.values()]
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    logs = cuda_build.build_all(sources + extra + [src.path.read_text() for src in HAND_SOURCES])
    build_s = time.perf_counter() - t0
    print(f"build: planned 10 graphs and {len(extra)} more compiles in {plan_s:.2f} s; "
          f"nvcc built {len(logs)} libraries (the compiles' and {len(HAND_SOURCES)} "
          f"hand-written) in parallel in {build_s:.2f} s")
    ptxas = [line.split("ptxas info    :")[-1].strip()
             for log in logs.values() for line in log.splitlines()
             if "Compiling entry" in line or "Used" in line or "spill" in line]
    for line in ptxas:
        print("  ptxas:", line)
    regs = ptxas_by_kernel(logs)
    graphs = {}
    for name, build in ALL_GRAPHS.items():
        module = build()
        # the eager step loop: phase 3 counts each launch through its wrapper
        compiled = compile_module(module, StitchOptions(jit_replay=False), device=dev)
        feeds = random_feeds(module, np.random.RandomState(0))
        dfeeds = {k: torch.as_tensor(v, device=dev) for k, v in feeds.items()}
        graphs[name] = (module, compiled, feeds, dfeeds)

    # ---- 3. the main path, with launch counters ---------------------------------
    programs = {}          # id -> (graph, program, kernel)
    for name, (_, compiled, _, _) in graphs.items():
        for k in compiled.kernels:
            programs[id(k.fn)] = (name, k.fn, k)
    for _, prog, _ in programs.values():
        prog.launches = 0
    outputs = {name: compiled(dfeeds) for name, (_, compiled, _, dfeeds) in graphs.items()}
    torch.cuda.synchronize()
    launches = {pid: prog.launches for pid, (_, prog, _) in programs.items()}
    total_planned = 0
    for name, (_, compiled, _, _) in graphs.items():
        got = sum(launches[id(k.fn)] for k in compiled.kernels)
        want = compiled.stats.stitched_kernels
        total_planned += want
        if got != want:
            raise SystemExit(f"{name}: {got} kernel launches, planned {want}")
    never = [prog.name for pid, (_, prog, _) in programs.items() if launches[pid] == 0]
    if never:
        raise SystemExit(f"kernels the main path never launched: {never}")
    print(f"main path: {sum(launches.values())} launches of {len(programs)} unique kernels "
          f"= {total_planned} planned fused kernels")

    # ---- 4. right ---------------------------------------------------------------
    for name, (module, compiled, feeds, dfeeds) in graphs.items():
        want = reference_execute(module, dfeeds, device=dev)
        for root, w in want.items():
            g = outputs[name][root]
            if g.device.type != "cuda" or tuple(g.shape) != tuple(w.shape):
                raise SystemExit(f"{name}:{root}: {g.device} {tuple(g.shape)} vs {tuple(w.shape)}")
            if not bool(torch.isfinite(g).all()):
                raise SystemExit(f"{name}:{root}: non-finite output")
            err, ok = max_err(g, w, degenerate_mask(name, root, feeds, tuple(g.shape)))
            if not ok:
                raise SystemExit(f"{name}:{root}: max |compiled - reference| {err:.3e} over tolerance")
    captured = {}
    for pid, (_, prog, _) in programs.items():
        def record(*a, device, _pid=pid, _launch=prog.launch):
            captured.setdefault(_pid, [t.clone() for t in a])
            return _launch(*a, device=device)
        prog.launch = record
    for name, (_, compiled, _, dfeeds) in graphs.items():
        compiled(dfeeds)
    for _, prog, _ in programs.values():
        del prog.launch
    rows, timed = [], []
    for pid, (gname, prog, kernel) in programs.items():
        a = captured[pid]
        got = prog.launch(*a, device=dev)
        want = prog.plain(*a, device=dev)
        torch.cuda.synchronize()
        err, ok = 0.0, True
        feeds = graphs[gname][2]
        for r, g, w in zip(kernel.outputs, got, want, strict=True):
            mask = degenerate_mask(gname, r.name, feeds, tuple(g.shape)) if not r.users else None
            e, o = max_err(g, w, mask)
            err, ok = max(err, e), ok and o
        if not ok:
            raise SystemExit(f"{gname}:{kernel.fusion.name} {prog.name}: kernel vs plain {err:.3e}")
        nbytes, ops = work(kernel)
        rows.append({
            "graph": gname, "fusion": kernel.fusion.name, "kernel": prog.name,
            "emitter": prog.emitter, "blocks": kernel.blocks, "phases": kernel.num_phases,
            "members": len(kernel.fusion.members), "launches": launches[pid], "max_abs_err": err, "bytes": nbytes, "ops": ops,
        })
        timed.append((prog, a))
    print(f"right: 10 graphs vs reference_execute and {len(rows)} kernels vs their plain "
          f"versions on the card, within rtol=atol={TOL} ({DEGENERATE_TOL} on Speech's "
          "degenerate columns)")
    stitched_rows = []
    rng = np.random.RandomState(1)
    for label, name, opts, blocks in STITCHED_COMPILES:
        compiled = stitched_compile(name, opts, dev)
        (kernel,) = [k for k in compiled.kernels if k.fn.emitter == "emit_stitched_fusion"]
        if [p.solution.blocks for p in kernel.stitched.phases] != blocks:
            raise SystemExit(f"{label}: phases of {[p.solution.blocks for p in kernel.stitched.phases]} "
                             f"plan blocks, expected {blocks}")
        a = [torch.as_tensor(rng.uniform(-1, 1, shape).astype(np.float32), device=dev)
             for shape, _ in kernel.fn.in_specs]
        kernel.fn.launches = 0
        got = kernel.fn(*a)
        torch.cuda.synchronize()
        if kernel.fn.launches != 1:
            raise SystemExit(f"{label}: {kernel.fn.launches} launches, expected 1")
        want = kernel.fn.plain(*a, device=dev)
        err, ok = 0.0, True
        for g, w in zip(got, want, strict=True):
            e, o = max_err(g, w, None)
            err, ok = max(err, e), ok and o and bool(torch.isfinite(g).all())
        if not ok:
            raise SystemExit(f"{label} {kernel.fn.name}: kernel vs plain {err:.3e}")
        _, by_name = device_profile(lambda p=kernel.fn, a=a: p.launch(*a, device=dev), PROFILED_CALLS)
        device_us = sum(t for k, t in by_name.items() if kernel.fn.name in k) or None
        stitched_rows.append({"compile": label, "kernel": kernel.fn.name, "phase_blocks": blocks,
                              "workspace_bytes": kernel.fn.workspace_bytes, "max_abs_err": err,
                              "device_us": device_us})
        print(f"stitched compile {label}: {kernel.fn.name} phases of {blocks} plan blocks, one "
              f"launch, err={err:.2e} device_us={device_us or 'not measured'}")

    extra_rows = []
    for label, name, dt, opts, emitter, tol in (
            DTYPE_COMPILES + [(lb, nm, "float32", op, "emit_fusion", (TOL, TOL)) for lb, nm, op in FUSION_COMPILES]):
        module, compiled = dtype_compile(name, dt, opts, dev)
        if {k.fn.emitter for k in compiled.kernels} != {emitter}:
            raise SystemExit(f"{label}: emitters {sorted({k.fn.emitter for k in compiled.kernels})}, "
                             f"expected {emitter}")
        feeds = {}
        for p in module.parameters:
            if dt in ("int8", "int16"):
                feeds[p.name] = torch.as_tensor(rng.randint(-60, 120, p.shape).astype(dt), device=dev)
            else:
                f = torch.as_tensor(rng.uniform(-2, 2, p.shape).astype(np.float32), device=dev)
                feeds[p.name] = f.to(torch.bfloat16) if dt == "bfloat16" else f
        inputs = {}
        for k in compiled.kernels:
            k.fn.launches = 0

            def record(*a, device, _fn=k.fn, _launch=k.fn.launch):
                inputs.setdefault(id(_fn), [t.clone() for t in a])
                return _launch(*a, device=device)
            k.fn.launch = record
        got = compiled(feeds)
        torch.cuda.synchronize()
        for k in compiled.kernels:
            del k.fn.launch
        n = sum(k.fn.launches for k in compiled.kernels)
        if n != compiled.stats.stitched_kernels:
            raise SystemExit(f"{label}: {n} launches, planned {compiled.stats.stitched_kernels}")
        want = reference_execute(module, feeds, device=dev)
        err, ok = 0.0, True
        for root, w in want.items():
            e, o = compare(got[root], w, tol)
            err, ok = max(err, e), ok and o
        # and each kernel against its plain version, on the inputs the run gave it
        for k in compiled.kernels:
            a = inputs[id(k.fn)]
            for g, w in zip(k.fn.launch(*a, device=dev), k.fn.plain(*a, device=dev), strict=True):
                e, o = compare(g, w, tol)
                err, ok = max(err, e), ok and o
        torch.cuda.synchronize()
        if not ok:
            raise SystemExit(f"{label}: kernels vs plain and reference_execute {err:.3e} over {tol}")
        names = [k.fn.name for k in compiled.kernels]
        _, by_name = device_profile(lambda c=compiled, f=feeds: c(f), PROFILED_CALLS)
        device_us = sum(t for k, t in by_name.items() if any(nm in k for nm in names)) or None
        extra_rows.append({"compile": label, "emitter": emitter, "kernels": names, "launches": n,
                           "max_abs_err": err, "tolerance": tol, "device_us": device_us,
                           "workspace_bytes": [k.fn.workspace_bytes for k in compiled.kernels]})
        print(f"{emitter} compile {label}: {n} launches, vs plain and reference_execute "
              f"err={err:.2e} (rtol, atol)={tol} device_us={device_us or 'not measured'}")

    # ---- 5. numbers -------------------------------------------------------------
    for row, (prog, a) in zip(rows, timed, strict=True):
        row["us"] = 1e3 * time_ms(lambda p=prog, a=a: p.launch(*a, device=dev), CALLS)
        _, by_name = device_profile(lambda p=prog, a=a: p.launch(*a, device=dev), PROFILED_CALLS)
        # None where the profiler recorded no device time for it
        row["device_us"] = sum(t for k, t in by_name.items() if prog.name in k) or None
        row["plain_us"] = 1e3 * time_ms(lambda p=prog, a=a: p.plain(*a, device=dev), PLAIN_CALLS)
        b_us = 1e6 * row["bytes"] / HBM_BYTES_PER_S
        o_us = 1e6 * row["ops"] / F32_OPS_PER_S
        row["bound_us"] = max(b_us, o_us)
        row["bound_by"] = "bytes" if b_us >= o_us else "operations"
        if row["emitter"] == "emit_fusion":
            row.update(geometry(prog.source), **regs.get(prog.name, {}))
            print(f"  {row['graph']}:{row['fusion']} {prog.name}: {row['members']} members, "
                  f"{row['blocks']} plan blocks, grid {row['grid']} x {row['threads']} threads, "
                  f"{row['smem_bytes']} bytes of shared memory, "
                  f"registers {row.get('registers', 'not built here')}, spill stores "
                  f"{row.get('spill_stores', '-')} loads {row.get('spill_loads', '-')}")
        print(
            f"kernel {row['graph']}:{row['fusion']} {row['emitter']} {row['kernel']} "
            f"blocks={row['blocks']} launches/call={row['launches']} "
            f"us={row['us']:.2f} device_us={row['device_us'] or 'not measured'} "
            f"plain_us={row['plain_us']:.2f} "
            f"bound_us={row['bound_us']:.4f} ({row['bound_by']}) err={row['max_abs_err']:.2e}"
        )
    per_graph = []
    for name, (module, compiled, _, dfeeds) in graphs.items():
        st = compiled.stats
        us = 1e3 * time_ms(lambda c=compiled, f=dfeeds: c(f), CALLS)
        ref_us = 1e3 * time_ms(lambda m=module, f=dfeeds: reference_execute(m, f, device=dev), CALLS)
        planned = st.stitched_kernels + st.standalone_kernels + st.library_calls
        seen, by_name = device_profile(lambda c=compiled, f=dfeeds: c(f), PROFILED_CALLS)
        device_us = sum(by_name.values()) or None
        idle = 1.0 - device_us / us if device_us else None
        # the unfused path's device time: every device kernel its torch ops run
        ref_seen, ref_by_name = device_profile(
            lambda m=module, f=dfeeds: reference_execute(m, f, device=dev), PROFILED_CALLS)
        ref_device_us = sum(ref_by_name.values()) or None
        per_graph.append({
            "graph": name, "us_per_call": us, "reference_us_per_call": ref_us,
            "fused_kernels": st.stitched_kernels, "standalone": st.standalone_kernels,
            "library_dots": st.library_calls, "unique_kernels": st.unique_kernels,
            "xla_baseline_kernels": st.xla_baseline_kernels, "planned_launches": planned,
            "profiler_device_kernels": seen, "device_us_per_call": device_us,
            "device_idle_share": idle, "reference_device_kernels": ref_seen,
            "reference_device_us_per_call": ref_device_us,
        })
        print(
            f"graph {name}: us_per_call={us:.1f} reference_us_per_call={ref_us:.1f} "
            f"fused={st.stitched_kernels} standalone={st.standalone_kernels} "
            f"library={st.library_calls} planned_launches={planned} "
            f"profiler_device_kernels={seen if seen else 'none seen'} "
            f"device_us_per_call={device_us or 'not measured'} "
            f"idle_share={idle if idle is not None else 'not measured'} "
            f"reference_device_kernels={ref_seen if ref_seen else 'none seen'} "
            f"reference_device_us_per_call={ref_device_us or 'not measured'}"
        )

    entries = []
    for emitter in ("emit_fusion", "emit_stitched_fusion"):
        mine = [r for r in rows if r["emitter"] == emitter]
        total_bytes = sum(r["bytes"] * r["launches"] for r in mine)
        total_ops = sum(r["ops"] * r["launches"] for r in mine)
        b_ms, o_ms = 1e3 * total_bytes / HBM_BYTES_PER_S, 1e3 * total_ops / F32_OPS_PER_S
        entries.append({
            "name": emitter, "route": "cuda", "source": "src/repro_torch/core/codegen.py",
            "replaces": REPLACES[emitter],
            "launches": sum(r["launches"] for r in mine),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            # this emitter's launches in one pass of the main path, each at
            # its CUDA-event time per back-to-back launch of the wrapper
            "ms": sum(r["us"] * r["launches"] for r in mine) / 1e3,
            "plain_ms": sum(r["plain_us"] * r["launches"] for r in mine) / 1e3,
            # the same launches' device time alone, as torch.profiler traced it
            "device_ms": (
                sum(r["device_us"] * r["launches"] for r in mine) / 1e3
                if all(r["device_us"] for r in mine) else None
            ),
            "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": None,
            "unique_kernels": len(mine), "tolerance": TOL,
        })
        if emitter == "emit_stitched_fusion":
            # the same graphs unfused (reference_execute), device time per pass
            ref_us = [g["reference_device_us_per_call"] for g in per_graph
                      if g["graph"] in {r["graph"] for r in mine}]
            entries[-1]["unfused_device_ms"] = sum(ref_us) / 1e3 if all(ref_us) else None

    # ---- 6. kernels ---------------------------------------------------------------
    hand_entries, hand_calls = kernels_phase(dev)
    entries += hand_entries

    # ---- 7-11. replay, loops, verify, autotune, f16 and the fault modules ---------
    replay_rows = replay_phase(dev, graphs, outputs)
    loop_rows = loops_phase(dev)
    verify_phase()
    autotune_rows = autotune_phase(dev, graphs)
    f16 = f16_phase(dev)
    for entry in hand_entries:
        entry.update(f16[entry["name"]])
    fault_rows = faults_phase(dev)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "build_s": build_s, "ptxas": ptxas,
                       "graphs": per_graph, "kernels": rows, "emitters": entries,
                       "stitched_compiles": stitched_rows, "extra_compiles": extra_rows,
                       "hand_kernel_calls": hand_calls, "replay": replay_rows, "loops": loop_rows,
                       "autotune": autotune_rows, "fault_modules": fault_rows}, f, indent=1)
    print(f"card: {smi}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
