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
12. frontend — ``repro_torch.stitch`` with the device left at its default
   (the card), eager (``jit_replay=False``) and replayed, over
   ``frontend_cases``: the three ``TORCH_FAMILIES`` at the reference's
   dimensions, StitchPipe's computation (the stitched emitter's plan,
   held against ``stitch_pipeline_graph`` as a family is), four end-to-end functions at granite-moe-3b-a800m's width
   over 512 tokens (rmsnorm and layer_stats on (512, 1536), the gated MLP
   with two (1536, 512) weights, the Figure-3 attention on q, k, v of
   (1, 24, 512, 64)), a decode-loop scan, a counted while_loop, a cond
   both ways and ``grad_and_value`` of an MLP loss.  The plans' sources
   are built in phase 2.  Each function's counters are set to 0 just
   before one eager call and read just after: its planned launches, every
   generated kernel at least once, and for a family the hand-built
   graph's plan (stitched, standalone, library) and launches, compiled by
   the port under the same options.  Zero fallbacks; outputs against the
   plain function run eagerly on the card and against ``reference_execute``
   of the lowered module at ``TOL``; two default calls through ``stitch``
   (the path ``replay_mode`` picks) and two of the plan's replay
   (``jit_execute``) bit for bit the eager plan's.  Printed per function:
   capture, lower and compile seconds; fused kernels and library dots; the
   device kernels a call of the plain function launches against the plan's
   (the profiler); µs per call (CUDA events, 200 calls) through ``stitch``
   eager and by default, of the plan's own replay (which leaves out
   ``stitch``'s host path) and of the plain function; device µs and idle
   share of each.  Last, ``donate_argnums`` on the card: a donated input's
   buffer takes a later kernel's output, the other inputs unchanged.
13. models — ``repro_torch.models`` on the card, no kernel of the port on
   its path (every kernel's launch count, the hand-written kernels'
   counters and the generated kernels' tally by emitter, is set to 0
   before it and must read 0 after: the reference's models call no Pallas
   kernel).  Each
   of the ten architectures at ``reduced_config``: ``forward`` and
   ``decode_chunk`` (ragged lengths; Whisper after
   ``prefill_cross_attention``) on the card against the port on the CPU,
   same seeded weights, f32 with TF32 off, at ``FAMILY_TOL``.  Then
   granite-moe-3b-a800m at full width in f32: 2 layers, ``forward`` of
   1 x 64 tokens on the card against the CPU (``GRANITE_CPU_TOL``); at
   full depth (32 layers) with dense MoE, ``decode_chunk`` over a 4 x 64
   prompt with ragged lengths against ``forward``'s logits at each row's
   last position (``DECODE_TOL``), and the paged cache (blocks of 16 from a
   shuffled pool) against the slot cache over the same chunk, one row
   inactive: logits and the written K/V bit for bit, the two read views
   one shape (``SLOT_MAX_LEN``).  Last, in bf16 with the default scatter
   MoE at full width and depth: ``forward`` of 4 x 512 tokens (ms by CUDA
   events, tokens/s, device ms, device kernels and idle share from
   torch.profiler), a 512-token context built by ``decode_chunk`` of 32
   tokens (ms each), ``decode_step`` at batch 4 over it (ms, device ms,
   device kernels a step, idle share, and the bound: the parameters' bytes
   over 3.35 TB/s, as decode reads every expert), parameter bytes and peak
   allocated bytes beside the card's name and power limit.
14. serving — ``repro_torch.serve`` on the card, each engine step (decode,
   prefill chunk) captured once into a CUDA graph and replayed, no kernel
   of the port on its path (the launch counts are set to 0 before it and
   must read 0 after, as in phase 13).  (a) Each architecture at ``reduced_config``, f32 with
   TF32 off: a seeded trace through ``PagedServeEngine`` (Whisper through
   ``ServeEngine``: its paged cache raises, as the reference's does), the
   card's replayed engine against the CPU's eager engine: every request's
   tokens and every ``stats()`` counter equal.  (b) granite-moe-3b-a800m
   at full width and depth in its own bf16, tokens bit for bit: paged
   against slot for the reference's single-request prompt lengths at one
   width and ``max_len`` 31 (the slot ring's 32 slots equal the paged
   view's 2 blocks of 16); preemption-resume (a pool of one max-length
   context, two requests) against solo runs at that width; and (c)'s trace
   replayed against eager, counters equal.  (c) One seeded Poisson trace
   (16 requests, prompts of 16-64 tokens, 8-16 new) through the paged
   engine (width 8, ``max_len`` 255, blocks of 16, chunks of 16), eager then
   replayed: tokens/s, TTFT and latency p50/p99, a decode launch with every
   row active (ms by CUDA events; device ms, device kernels and idle share
   from torch.profiler; the bound: the parameters' bytes over 3.35 TB/s), a
   prefill launch (the median ms of ``SERVE_PREFILL_CALLS`` launches, each
   between its own CUDA events), each graph's capture and instantiation seconds, max
   inflight, KV peak utilization and peak allocated bytes, beside the
   card's name and power limit.  (d) ``repro_torch.launch.serve.main`` at
   full width for 8 requests must finish every one.

Every profile whose device kernels a call are none or not a whole number,
or disagree with the plan, is taken again (up to ``PROFILE_TRIES``), and
each refused reading, with the pad kernels it kept, goes into ``--out`` as
``profile_retakes``.

Before the last two lines, phase 13's and phase 14's numbers as one JSON
object each (``models``, ``serve``).  The line before the last is one JSON
object with a ``kernels`` list: one
entry per emitter (``emit_fusion`` and ``emit_stitched_fusion``, with its
launches in phase 12's counted calls as ``frontend_launches``, in phase
13's as ``models_launches`` and in phase 14's as ``serve_launches``) and
one per
hand-written kernel (with its f16 numbers as ``f16_*`` keys); the last
line is ``{"ok": true, "device": {...}}``.  ``--out`` also writes every
per-graph, per-kernel and per-function number as JSON (phase 12's under
``"frontend"``, phase 14's under ``"serve"``), with nvcc's register, shared-memory and spill lines.  Exits
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
               top_k=8, vocab=49155, norm_eps=1e-6, d_ff=512)

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


def time_ms(fn, calls, warm=True):
    """Milliseconds per call: CUDA events around ``calls`` calls, after as
    many warm-up calls (up to ``WARMUP``) unless ``warm`` is False."""
    import torch

    for _ in range(min(WARMUP, calls) if warm else 0):
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


#: ``torch.cuda._sleep``'s kernel, launched around the profiled calls (16 a
#: side: a session of some 11,000 device kernels lost 4 pads and 1-2 kernels
#: at an edge in 5 of 6 profiles with 4)
PAD_KERNEL = "spin_kernel"
PAD_LAUNCHES = 16
#: profiles taken of one function before one whose kernel count is wrong fails
PROFILE_TRIES = 8
#: every profile taken again: (label, each reading that was refused)
RETAKES = []


def device_events(fn, calls):
    """The device kernels of ``calls`` calls as torch.profiler records
    them: a list of (name, device microseconds), and how many of the
    ``2 * PAD_LAUNCHES`` pad kernels it recorded.  The calls sit between
    ``PAD_LAUNCHES`` short ``torch.cuda._sleep`` kernels on each side,
    which the list leaves out: the profiler lost device kernels of some
    sessions on an H100, and the pads say whether a loss reached the
    session's edges (on the H100 it took whole sessions, pads included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PAD_LAUNCHES):
            torch.cuda._sleep(1000)
        for _ in range(calls):
            fn()
        for _ in range(PAD_LAUNCHES):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    device = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return ([(n, us) for n, us in device if PAD_KERNEL not in n],
            sum(1 for n, _ in device if PAD_KERNEL in n))


def profile_again(label, reading):
    """Record a refused profile (kept in ``--out`` as ``profile_retakes``)
    and say so."""
    if not RETAKES or RETAKES[-1]["label"] != label:
        RETAKES.append({"label": label, "refused": []})
    RETAKES[-1]["refused"].append(reading)
    print(f"{label}: profile {len(RETAKES[-1]['refused'])} refused, {reading}: taken again")


def device_profile(fn, calls, label="profile", per_call=None):
    """Device activity of ``calls`` calls as torch.profiler records it: the
    device kernels per call, and their device microseconds per call by
    kernel name.  A profile whose device kernels a call are none or not a
    whole number (events lost) is taken again, up to ``PROFILE_TRIES``
    times, and so is one in which ``per_call`` (names, n), where given,
    does not hold: the kernels whose names hold one of ``names`` number n
    a call."""
    readings = []
    for _ in range(PROFILE_TRIES):
        events, pads = device_events(fn, calls)
        seen = len(events) / calls
        mine = None
        if per_call is not None:
            mine = sum(1 for n, _ in events if any(k in n for k in per_call[0])) / calls
        if seen > 0 and seen.is_integer() and (per_call is None or mine == per_call[1]):
            by_name = {}
            for name, us in events:
                by_name[name] = by_name.get(name, 0.0) + us / calls
            return seen, by_name
        reading = {"device_kernels_a_call": seen, "pads_seen": pads, "named_a_call": mine}
        readings.append(reading)
        profile_again(label, reading)
    raise SystemExit(f"{label}: no profile in {PROFILE_TRIES} recorded whole calls; read {readings}")


def profiled_launches(label, fn, want, total=None):
    """Hold the device kernels that torch.profiler sees in ``PROFILED_CALLS``
    calls of ``fn`` against a plan: ``want`` maps each generated kernel's
    name to its launches a call, and ``total``, where given, is every
    device kernel a call must run.  Returns (device kernels a call, device
    µs a call by kernel name) of the profile that agreed.  The profiler
    drops a run's events now and then (it once saw 0.35 kernels a call of a
    graph that runs 4): a profile that disagrees, or whose device kernels a
    call are not a whole number (an event of a library call lost), is
    taken again, up to ``PROFILE_TRIES`` times, and one that never agrees
    fails the run."""
    readings = []
    for _ in range(PROFILE_TRIES):
        events, pads = device_events(fn, PROFILED_CALLS)
        seen = len(events) / PROFILED_CALLS
        got = {k: sum(1 for name, _ in events if k in name) / PROFILED_CALLS for k in want}
        if got == want and seen.is_integer() and (total is None or seen == total):
            by_name = {}
            for name, us in events:
                by_name[name] = by_name.get(name, 0.0) + us / PROFILED_CALLS
            return seen, by_name
        readings.append((seen, got))
        profile_again(label, {"device_kernels_a_call": seen, "pads_seen": pads,
                              "generated_a_call": got, "plan": want, "total": total})
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
    mine = (DEVICE_KERNEL[c["kernel"]], len(launchers(c["kernel"], None)))
    device_us = device_us_of(c["kernel"], device_profile(
        c["call"], PROFILED_CALLS, f"{c['kernel']} {c['label']}", per_call=mine)[1])
    library_device_us = (sum(device_profile(c["library"], PROFILED_CALLS,
                                            f"library of {c['kernel']} {c['label']}")[1].values())
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
            PROFILED_CALLS, "stitched_rmsnorm cold L2",
            per_call=(DEVICE_KERNEL["stitched_rmsnorm"], 1))[1])
        lib_us = (sum(device_profile(
            lambda: F.rms_norm(xs[next(turn) % COLD_ROTATION], (d,), gamma, g["norm_eps"]),
            PROFILED_CALLS, "F.rms_norm cold L2")[1].values()) if c["library"] else 0.0)
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


# ---- phase 12: the frontend ----------------------------------------------------

#: the options the frontend's functions compile under, as in
#: tests/test_torch_frontend.py (each family adds its own overrides)
FRONTEND_MAX_BLOCKS = 32
#: tokens of the granite-width functions
FRONTEND_TOKENS = 512


def frontend_cases():
    """Phase 12's functions: (name, fn, numpy args, StitchOptions, family).
    The three ``TORCH_FAMILIES`` at the reference's dimensions and
    StitchPipe's computation (held against its hand-built graph); four of
    tests/test_torch_frontend.py's functions at granite-moe-3b-a800m's width
    over ``FRONTEND_TOKENS`` tokens; the control-flow functions and the MLP
    loss's gradient of tests/test_torch_frontend_controlflow.py at its
    sizes."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch._higher_order_ops.scan import scan
    from torch._higher_order_ops.while_loop import while_loop

    from repro_torch.core import StitchOptions
    from repro_torch.graphs import TORCH_FAMILIES, stitch_pipeline_graph

    opts = StitchOptions(max_blocks=FRONTEND_MAX_BLOCKS)

    def fig3_attention(q, k, v):
        d = q.shape[-1]
        s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / d ** 0.5)
        s = s - torch.amax(s, dim=-1, keepdim=True)
        e = torch.exp(s)
        return torch.matmul(e / torch.sum(e, dim=-1, keepdim=True), v)

    def rmsnorm(x, g):
        ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
        return x * torch.rsqrt(ms + 1e-6) * g

    def gated_mlp(x, w_gate, w_up):
        return F.silu(torch.matmul(x, w_gate)) * torch.matmul(x, w_up)

    def layer_stats(x):
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-5)

    def decode_loop(h, w):
        def step(carry, _x):
            carry = torch.tanh(carry @ w)
            return carry.clone(), carry.sum(dim=-1)

        return scan(step, h, torch.zeros(6, 0, device=h.device))

    def stitch_pipe(x, g):
        scaled = x * g
        e = torch.exp(scaled - torch.amax(scaled, dim=1, keepdim=True))
        p = e / torch.sum(e, dim=1, keepdim=True)
        return torch.tanh(p.transpose(0, 1)) * 0.5

    def counted_while(x):
        return while_loop(lambda i, v: i < 5, lambda i, v: (i + 1, v * 1.1 + 0.25),
                          (torch.tensor(0, device=x.device), x))[1]

    def cond(pred, x):
        return torch.cond(pred, lambda v: v * 2.0, lambda v: v - 1.0, (x,))

    def mlp_loss(params, x, y):
        h = torch.tanh(x @ params["w1"] + params["b1"])
        pred = h @ params["w2"] + params["b2"]
        return torch.mean((pred - y) ** 2)

    cases = []
    for name, fam in TORCH_FAMILIES.items():
        cases.append((name, fam["fn"], fam["args"](np.random.RandomState(0)),
                      dataclasses.replace(opts, **fam["options"]), fam))
    # StitchPipe's computation, whose plan takes the stitched emitter
    cases.append(("StitchPipe", stitch_pipe,
                  tuple(np.random.RandomState(0).randn(*sh).astype(np.float32)
                        for sh in ((512, 320), (320,))),
                  opts, {"module": stitch_pipeline_graph}))
    rng = np.random.RandomState(1)
    t, d, ff = FRONTEND_TOKENS, GRANITE["d_model"], GRANITE["d_ff"]
    h, hd = GRANITE["heads"], GRANITE["head_dim"]
    f4 = np.float32
    cases += [
        ("rmsnorm", rmsnorm, (rng.randn(t, d).astype(f4), rng.randn(d).astype(f4)), opts, None),
        ("layer_stats", layer_stats, (rng.randn(t, d).astype(f4),), opts, None),
        ("gated_mlp", gated_mlp, (rng.randn(t, d).astype(f4), rng.randn(d, ff).astype(f4),
                                  rng.randn(d, ff).astype(f4)), opts, None),
        ("fig3_attention", fig3_attention,
         tuple(rng.randn(1, h, t, hd).astype(f4) for _ in range(3)), opts, None),
    ]
    g = np.random.default_rng(0)
    params = {"w1": g.normal(size=(8, 16), scale=0.3).astype(f4), "b1": np.zeros(16, f4),
              "w2": g.normal(size=(16, 4), scale=0.3).astype(f4), "b2": np.zeros(4, f4)}
    cases += [
        ("decode_loop_scan", decode_loop,
         (g.normal(size=(4, 16)).astype(f4), g.normal(size=(16, 16), scale=0.2).astype(f4)),
         opts, None),
        ("counted_while_loop", counted_while, (np.linspace(0.0, 1.0, 12, dtype=f4),), opts, None),
        ("cond_true", cond, (np.asarray(True), np.arange(8, dtype=f4)), opts, None),
        ("cond_false", cond, (np.asarray(False), np.arange(8, dtype=f4)), opts, None),
        ("grad_mlp_loss", torch.func.grad_and_value(mlp_loss),
         (params, g.normal(size=(32, 8)).astype(f4), g.normal(size=(32, 4)).astype(f4)),
         opts, None),
    ]
    return cases


def frontend_sources(cases):
    """The CUDA sources phase 12 builds: each function's plan, compiled here
    for the CPU (the same text the card's compile emits), and each family's
    hand-built module's, and ``donation_check``'s function's."""
    from repro_torch import stitch
    from repro_torch.core import compile_module

    out = []
    for _, fn, args, opts, fam in cases + [("donation", *donation_case(), None)]:
        out += sources_of(stitch(fn, options=opts, device="cpu").lower(*args).compile())
        if fam is not None:
            out += sources_of(compile_module(fam["module"](), opts, device="cpu"))
    return out


def frontend_phase(dev, cases):
    """Phase 12: ``repro_torch.stitch`` on the card, the device left at its
    default, eager and replayed (see the module docstring).  Returns the
    rows and each emitter's launches in the counted eager calls."""
    import dataclasses

    import numpy as np
    import torch
    import torch.utils._pytree as pytree

    from repro_torch import stitch
    from repro_torch.core import compile_module, reference_execute

    rows, by_emitter = [], {"emit_fusion": 0, "emit_stitched_fusion": 0}
    for name, fn, args, opts, fam in cases:
        dargs = pytree.tree_map(lambda a: torch.as_tensor(a, device=dev), args)
        st_e = stitch(fn, options=dataclasses.replace(opts, jit_replay=False))
        st_r = stitch(fn, options=opts)
        if st_e.device is not None or st_r.device is not None:
            raise SystemExit(f"frontend {name}: the device is not left at its default")
        t0 = time.perf_counter()
        st_e(*dargs)                                  # capture, lower, compile, run
        torch.cuda.synchronize()
        first_call_s = time.perf_counter() - t0
        lowered = st_e.lower()
        comp_e = lowered.compile()
        if comp_e.stats.device != "cuda":
            raise SystemExit(f"frontend {name}: compiled for {comp_e.stats.device}")
        progs = programs_of(comp_e)
        for p in progs.values():
            p.launches = 0
        out_e = st_e(*dargs)
        torch.cuda.synchronize()
        got = sum(p.launches for p in progs.values())
        want = planned_launches(comp_e)
        never = [p.name for p in progs.values() if p.launches == 0]
        if got != want or never:
            raise SystemExit(f"frontend {name}: {got} launches, planned {want}; never launched {never}")
        for p in progs.values():
            by_emitter[p.emitter] += p.launches
        s = comp_e.stats
        stats = (s.stitched_kernels, s.standalone_kernels, s.library_calls)
        if fam is not None:
            hand = compile_module(fam["module"](), opts, device=dev)
            hs = hand.stats
            if stats != (hs.stitched_kernels, hs.standalone_kernels, hs.library_calls) \
                    or want != planned_launches(hand):
                raise SystemExit(f"frontend {name}: plan {stats}, {want} launches; the hand-built "
                                 f"graph's ({hs.stitched_kernels}, {hs.standalone_kernels}, "
                                 f"{hs.library_calls}), {planned_launches(hand)} launches")
        if st_e.num_fallbacks or st_r.num_fallbacks:
            raise SystemExit(f"frontend {name}: {st_e.num_fallbacks + st_r.num_fallbacks} fallbacks")
        # right: against the plain function on the card and the lowered
        # module's reference_execute, on the same inputs
        leaves = pytree.tree_leaves(dargs)
        feeds = dict(zip(lowered.param_names, leaves, strict=True))
        flat_e = pytree.tree_leaves(out_e)
        plain = pytree.tree_leaves(fn(*dargs))
        ref = reference_execute(lowered.module, feeds, device=dev)
        ref_flat = [ref[n] for n in lowered._lowered.output_names]
        err = 0.0
        for label, want_flat in (("plain PyTorch", plain), ("reference_execute", ref_flat)):
            if len(want_flat) != len(flat_e):
                raise SystemExit(f"frontend {name}: {len(flat_e)} outputs, {label} {len(want_flat)}")
            for i, (g, w) in enumerate(zip(flat_e, want_flat, strict=True)):
                if g.device.type != "cuda" or tuple(g.shape) != tuple(w.shape) \
                        or not bool(torch.isfinite(g.double()).all()):
                    raise SystemExit(f"frontend {name}: output {i} is {g.device} {tuple(g.shape)}, "
                                     f"{label} {tuple(w.shape)}, or not finite")
                e, ok = max_err(g, w.to(g.dtype), None)
                err = max(err, e)
                if not ok:
                    raise SystemExit(f"frontend {name}: output {i} vs {label} {e:.3e} (TOL {TOL})")
        # replayed: two default calls through stitch (the path the plan's
        # replay_mode picks), then the plan's CUDA graph whatever the mode
        # (jit_execute, past stitch), each bit for bit the eager plan's (a
        # library dot may round otherwise under capture, held at TOL as in
        # phase 7)
        st_r(*dargs)
        lowered_r = st_r.lower()
        comp_r = lowered_r.compile()
        ex_r = comp_r.executable
        eager_d = comp_e(feeds)
        eager_flat = [eager_d[n] for n in lowered._lowered.output_names]
        replayed = [pytree.tree_leaves(st_r(*dargs)) for _ in range(2)]
        replayed += [[r[n] for n in lowered_r._lowered.output_names]
                     for r in (ex_r.jit_execute(feeds) for _ in range(2))]
        torch.cuda.synchronize()
        bitwise = all(same(g, w) for r in replayed for g, w in zip(r, eager_flat, strict=True))
        held = []
        if not bitwise:
            held = [i.name for i in ex_r.plan.standalone if i.is_library_call]
            for r in replayed:
                for i, (g, w) in enumerate(zip(r, eager_flat, strict=True)):
                    e, ok = max_err(g, w, None)
                    if not held or not ok:
                        raise SystemExit(f"frontend {name}: output {i} replayed vs eager {e:.3e}, "
                                         f"library dots {held}")
        # numbers: µs per call through stitch (eager, and the default path)
        # and of the plan's own replay, the plain function's device kernels
        # against the plan's, device µs and idle shares
        eager_us = 1e3 * time_ms(lambda: st_e(*dargs), CALLS)
        default_us = 1e3 * time_ms(lambda: st_r(*dargs), CALLS)
        replay_us = 1e3 * time_ms(lambda: ex_r.jit_execute(feeds), CALLS)
        plain_us = 1e3 * time_ms(lambda: fn(*dargs), CALLS)
        plan_e = planned_by_program(comp_e)
        e_seen, e_by = profiled_launches(f"frontend {name} eager", lambda: st_e(*dargs), plan_e)
        r_seen, r_by = profiled_launches(f"frontend {name} replayed",
                                         lambda: ex_r.jit_execute(feeds), planned_by_program(comp_r))
        p_seen, p_by = device_profile(lambda: fn(*dargs), PROFILED_CALLS, f"plain {name}")
        e_dev, r_dev, p_dev = sum(e_by.values()), sum(r_by.values()), sum(p_by.values())
        mode = comp_r.stats.replay_mode
        d_dev = r_dev if mode == "graph" else e_dev
        row = {
            "function": name, "args": [list(np.shape(a)) for a in pytree.tree_leaves(args)],
            "capture_s": st_e.capture_s, "lower_s": st_e.lower_s,
            "compile_s": s.compile_time_s, "nvcc_s": s.build_time_s, "first_call_s": first_call_s,
            "fused_kernels": s.stitched_kernels, "standalone": s.standalone_kernels,
            "library_dots": s.library_calls, "loop_calls": s.loop_calls,
            "sub_kernels": s.sub_kernels, "launches_per_call": want,
            "stitched_emitter_kernels": s.stitch_lowered_kernels,
            "fallbacks": st_e.num_fallbacks + st_r.num_fallbacks, "max_abs_err": err,
            "replay_mode": mode, "bitwise_replay_vs_eager": bitwise,
            "held_at_tol": held,
            "plain_device_kernels": p_seen, "stitched_device_kernels": e_seen,
            "replay_device_kernels": r_seen,
            # through stitch: the eager loop, and the default call (the path
            # replay_mode picks); the plan's own replay (jit_execute) leaves
            # out stitch's host path
            "eager_us_per_call": eager_us, "default_us_per_call": default_us,
            "plan_replay_us_per_call": replay_us, "plain_us_per_call": plain_us,
            "eager_device_us_per_call": e_dev, "replay_device_us_per_call": r_dev,
            "plain_device_us_per_call": p_dev,
            "eager_idle_share": 1.0 - e_dev / eager_us,
            "default_idle_share": 1.0 - d_dev / default_us,
            "plan_replay_idle_share": 1.0 - r_dev / replay_us,
            "plain_idle_share": 1.0 - p_dev / plain_us,
        }
        rows.append(row)
        print(f"frontend {name}: capture {row['capture_s']:.3f} s, lower {row['lower_s']:.3f} s, "
              f"compile {row['compile_s']:.3f} s; fused={s.stitched_kernels} "
              f"(stitched emitter {s.stitch_lowered_kernels}) standalone={s.standalone_kernels} "
              f"library={s.library_calls} loops={s.loop_calls}; {want} launches a call as planned"
              f"{' = the hand-built graph' if fam is not None else ''}; 0 fallbacks; "
              f"err={err:.2e} vs plain and reference_execute; replay "
              f"{'bitwise' if bitwise else 'held at TOL'} vs eager; device kernels a call "
              f"plain={p_seen} stitched={e_seen} replayed={r_seen}; us_per_call through stitch "
              f"eager={eager_us:.1f} default ({mode})={default_us:.1f}, the plan's "
              f"replay={replay_us:.1f}, plain={plain_us:.1f}; device_us "
              f"eager={e_dev:.2f} replay={r_dev:.2f} plain={p_dev:.2f}; idle_share "
              f"eager={row['eager_idle_share']:.3f} default={row['default_idle_share']:.3f} "
              f"plan_replay={row['plan_replay_idle_share']:.3f} "
              f"plain={row['plain_idle_share']:.3f}")
        if name == "fig3_attention" and (s.stitched_kernels, s.standalone_kernels,
                                         s.library_calls) != (1, 0, 0):
            print(f"frontend fig3_attention at granite width: {s.stitched_kernels} fused "
                  f"kernels, {s.standalone_kernels} standalone, {s.library_calls} library dots, "
                  f"not one stitched kernel, under the planner's budgets (vmem_limit "
                  f"{opts.vmem_limit} bytes, replicate_limit {opts.replicate_limit}, "
                  f"stitch_max_blocks {opts.stitch_max_blocks}, max_blocks {opts.max_blocks}):")
            print(st_e.report())
    donation_check(dev)
    return rows, by_emitter


def donation_case():
    """The function, numpy arguments and options of ``donation_check``."""
    import numpy as np
    import torch

    from repro_torch import StitchOptions

    def fn(x, w, y):
        return torch.tanh(torch.exp(x) @ w) + y

    rng = np.random.RandomState(2)
    args = tuple(rng.randn(256, 256).astype(np.float32) * 0.1 for _ in range(3))
    return fn, args, StitchOptions(max_blocks=FRONTEND_MAX_BLOCKS, fuse_dot=False, jit_replay=False)


def donation_check(dev):
    """``donate_argnums`` on the card: in the eager loop the second kernel of
    tanh(exp(x) @ w) + y (the dot a library call) writes its output into
    x's buffer through the launcher's ``out``; w and y stay as they were,
    and the result is the undonated plan's, bit for bit."""
    import torch

    from repro_torch import stitch

    fn, args, opts = donation_case()
    x, w, y = (torch.as_tensor(a, device=dev) for a in args)
    want = stitch(fn, options=opts)(x.clone(), w, y)
    w0, y0 = w.clone(), y.clone()
    st = stitch(fn, options=opts, donate_argnums=(0,))
    got = st(x, w, y)
    torch.cuda.synchronize()
    if st.stats.donated_buffers != 1 or got.data_ptr() != x.data_ptr() or not same(got, want) \
            or not same(w, w0) or not same(y, y0):
        raise SystemExit(f"frontend donation: {st.stats.donated_buffers} donated buffers, output "
                         f"in x's buffer {got.data_ptr() == x.data_ptr()}, equal to the undonated "
                         f"plan {same(got, want)}, w and y kept {same(w, w0) and same(y, y0)}")
    print("frontend donation: the second kernel wrote its output into the donated input's "
          "buffer; the other inputs unchanged; bit for bit the undonated plan's")


# ---- phase 13: the models --------------------------------------------------------
MODEL_ARCH = "granite-moe-3b-a800m"
#: card against CPU in f32 with TF32 off (rtol = atol): the reduced families'
#: logits differ by a few f32 ulps of sums taken in another order; at granite's
#: full width the 1536- and 2048-term sums move them by a few 1e-5
FAMILY_TOL = 1e-4
GRANITE_CPU_TOL = 1e-3
#: decode_chunk against forward at granite's full depth in f32: the reference's
#: test_decode_matches_forward holds them at 2e-3
DECODE_TOL = 2e-3
GRANITE_CPU_LAYERS = 2
PROMPT = (4, 64)                    # decode against forward, paged against slot
PROMPT_LENGTHS = (64, 50, 33, 64)   # ragged; the last row inactive in the paged check
PAGED_BLOCK = 16
#: the slot ring's SLOT_MAX_LEN + 1 slots (its parking slot) equal the paged
#: view's 5 blocks of 16: both read views have one shape, so bit for bit
SLOT_MAX_LEN = 79
FORWARD_SHAPE = (4, 512)
DECODE_BATCH, DECODE_CONTEXT, DECODE_CHUNK = 4, 512, 32
DECODE_MAX_LEN = 1024
MODEL_CALLS = 5                     # timed forward calls (CUDA events), after as many warm
DECODE_CALLS = 20                   # timed decode steps, after as many warm
MODEL_PROFILED = 3                  # calls traced by torch.profiler


def model_batch(cfg, B, S, seed):
    """Seeded tokens (and the VLM's patches, Whisper's frames), as numpy."""
    import numpy as np

    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, min(cfg.vocab_size, 4096), (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.randn(B, cfg.num_patches, cfg.d_model).astype(np.float32) * 0.02
    if cfg.family == "audio":
        batch["frames"] = rng.randn(B, cfg.encoder_seq, cfg.d_model).astype(np.float32) * 0.02
    return batch


def held(label, got, want, tol):
    """Max |got - want|; the run fails past rtol = atol = ``tol`` or on a
    value that is not finite."""
    import torch

    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    if got.shape != want.shape:
        raise SystemExit(f"models {label}: shape {tuple(got.shape)}, expected {tuple(want.shape)}")
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or not torch.allclose(got, want, rtol=tol, atol=tol):
        raise SystemExit(f"models {label}: max |err| {err:.3g} past {tol}")
    return err


def family_checks(dev):
    """Every architecture at ``reduced_config``: ``forward`` and
    ``decode_chunk`` on the card against the port on the CPU, the same
    seeded weights, f32."""
    import numpy as np

    from repro_torch import models
    from repro_torch.configs import ARCHITECTURES, get_config, reduced_config
    from repro_torch.models.module import tree_map

    rows = []
    for arch in sorted(ARCHITECTURES):
        cfg = reduced_config(get_config(arch))
        cpu = models.init_params(cfg, 0, device="cpu")
        card = tree_map(lambda t: t.to(dev), cpu)
        batch = model_batch(cfg, 2, 16, seed=1)
        f_err = held(f"{arch} forward", models.forward(card, batch, cfg),
                     models.forward(cpu, batch, cfg), FAMILY_TOL)
        toks, lengths = batch["tokens"][:, :8], np.array([8, 5], np.int32)
        outs = []
        for params, where in ((cpu, "cpu"), (card, dev)):
            cache = models.init_cache(cfg, 2, 16, device=where)
            if cfg.is_encoder_decoder:     # Whisper's cache takes the encoder's cross K/V
                xk, xv = models.prefill_cross_attention(params, batch["frames"], cfg, 2)
                cache["xk"].copy_(xk)
                cache["xv"].copy_(xv)
            outs.append(models.decode_chunk(params, cache, toks, 0, cfg, lengths=lengths)[0])
        d_err = held(f"{arch} decode_chunk", outs[1], outs[0], FAMILY_TOL)
        rows.append({"arch": arch, "forward_err": f_err, "decode_chunk_err": d_err})
        print(f"models {arch}: reduced, card vs cpu, f32: forward max |err| {f_err:.3g}, "
              f"decode_chunk {d_err:.3g} (tol {FAMILY_TOL})")
    return rows


def granite_checks(dev):
    """granite-moe-3b-a800m at full width in f32 (see the module docstring):
    2 layers on the card against the CPU; at full depth with dense MoE,
    decode_chunk against forward, and the paged cache against the slot
    cache bit for bit."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.models.module import tree_map

    base = dataclasses.replace(get_config(MODEL_ARCH), dtype="float32")
    row = {}
    # card against CPU, 2 layers, the config's own (scatter) MoE
    cfg = dataclasses.replace(base, num_layers=GRANITE_CPU_LAYERS)
    cpu = models.init_params(cfg, 0, device="cpu")
    batch = model_batch(cfg, 1, PROMPT[1], seed=2)
    want = models.forward(cpu, batch, cfg)
    card = tree_map(lambda t: t.to(dev), cpu)
    row["card_vs_cpu_err"] = held("granite 2 layers forward, card vs cpu",
                                  models.forward(card, batch, cfg), want, GRANITE_CPU_TOL)
    del cpu, card
    # full depth, dense MoE: decode against forward, paged against slot
    cfg = dataclasses.replace(base, moe_impl="dense")
    params = models.init_params(cfg, 0, device=dev)
    B, S = PROMPT
    toks = model_batch(cfg, B, S, seed=3)["tokens"]
    lengths = np.array(PROMPT_LENGTHS, np.int32)
    full = models.forward(params, {"tokens": toks}, cfg)
    at = full[torch.arange(B), torch.as_tensor(lengths - 1, device=dev)]
    cache = models.init_cache(cfg, B, SLOT_MAX_LEN, device=dev)
    t0 = time.perf_counter()
    got, cache = models.decode_chunk(params, cache, toks, 0, cfg, lengths=lengths)
    torch.cuda.synchronize()
    row["decode_chunk_64_f32_s"] = time.perf_counter() - t0
    row["decode_vs_forward_err"] = held("granite full depth decode_chunk vs forward", got, at,
                                        DECODE_TOL)
    # paged (blocks of 16 dealt from a seeded shuffle, a spare block) against slot
    active = np.array([True, True, True, False])
    nblk = -(-SLOT_MAX_LEN // PAGED_BLOCK)
    num_blocks = B * nblk + 1
    tables = np.random.RandomState(4).permutation(num_blocks)[: B * nblk].reshape(B, nblk)
    slot = models.init_cache(cfg, B, SLOT_MAX_LEN, device=dev)
    paged = models.init_paged_cache(cfg, num_blocks, PAGED_BLOCK, B, device=dev)
    a, slot = models.decode_chunk(params, slot, toks, 0, cfg, active, lengths)
    b, paged = models.decode_chunk(params, paged, toks, 0, cfg, active, lengths,
                                   tables, SLOT_MAX_LEN)
    torch.cuda.synchronize()
    tab = torch.as_tensor(tables, device=dev).long()
    kv_same = all(
        torch.equal(slot[n][:, r, :n_tok],
                    paged[n][:, tab[r]].flatten(1, 2)[:, :n_tok])
        for n in ("k", "v") for r, n_tok in enumerate(lengths) if active[r])
    if not torch.equal(a, b) or not kv_same or a[3].any():
        raise SystemExit(f"models granite paged vs slot: logits equal {torch.equal(a, b)}, "
                         f"K/V equal {kv_same}, inactive row zero {not a[3].any()}")
    row["paged_vs_slot"] = "bitwise"
    print(f"models {MODEL_ARCH}: full width f32, TF32 off: {GRANITE_CPU_LAYERS} layers card vs "
          f"cpu max |err| {row['card_vs_cpu_err']:.3g} (tol {GRANITE_CPU_TOL}); full depth "
          f"{cfg.num_layers} layers dense MoE: decode_chunk {PROMPT} (lengths {PROMPT_LENGTHS}) "
          f"vs forward max |err| {row['decode_vs_forward_err']:.3g} (tol {DECODE_TOL}); paged "
          f"(blocks of {PAGED_BLOCK}) vs slot cache bit for bit, one row inactive")
    return row


def top_kernels(by_name, n=8):
    """The ``n`` device kernels that take the most time a call: [name, µs]."""
    return [[name[:120], us] for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def granite_times(dev, smi):
    """granite-moe-3b-a800m at full width and depth in bf16 with the
    default scatter MoE: forward of FORWARD_SHAPE tokens, a context of
    DECODE_CONTEXT tokens built by decode_chunk of DECODE_CHUNK tokens,
    then decode_step at DECODE_BATCH (see the module docstring)."""
    import numpy as np
    import torch

    from repro_torch import models
    from repro_torch.configs import get_config

    cfg = get_config(MODEL_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = models.init_params(cfg, 0, device=dev)
    row = {"arch": MODEL_ARCH, "dtype": cfg.dtype, "moe_impl": cfg.moe_impl,
           "layers": cfg.num_layers, "param_count": models.count_params(params),
           "param_bytes": models.tree_bytes(params)}
    B, S = FORWARD_SHAPE
    batch = {"tokens": torch.as_tensor(model_batch(cfg, B, S, seed=5)["tokens"], device=dev)}
    logits = models.forward(params, batch, cfg)
    if tuple(logits.shape) != (B, S, cfg.padded_vocab) or not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"models forward bf16: shape {tuple(logits.shape)}, finite "
                         f"{bool(torch.isfinite(logits).all())}")
    del logits

    def fwd():
        return models.forward(params, batch, cfg)

    row["forward_shape"] = [B, S]
    row["forward_ms"] = time_ms(fwd, MODEL_CALLS)
    row["forward_tokens_per_s"] = B * S / (row["forward_ms"] / 1e3)
    kernels, by_name = device_profile(fwd, MODEL_PROFILED, label="models forward")
    row["forward_device_ms"] = sum(by_name.values()) / 1e3
    row["forward_device_kernels"] = kernels
    row["forward_idle_share"] = 1 - row["forward_device_ms"] / row["forward_ms"]
    row["forward_top_kernels"] = top_kernels(by_name)

    Bd = DECODE_BATCH
    cache = models.init_cache(cfg, Bd, DECODE_MAX_LEN, device=dev)
    ctx = torch.as_tensor(model_batch(cfg, Bd, DECODE_CONTEXT, seed=6)["tokens"], device=dev)
    chunk_ms = []
    for start in range(0, DECODE_CONTEXT, DECODE_CHUNK):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        last, cache = models.decode_chunk(params, cache, ctx[:, start:start + DECODE_CHUNK],
                                          start, cfg)
        t1.record()
        torch.cuda.synchronize()
        chunk_ms.append(t0.elapsed_time(t1))
    if not bool(torch.isfinite(last).all()):
        raise SystemExit("models decode_chunk bf16: logits not finite")
    row["decode_chunk_tokens"] = DECODE_CHUNK
    row["decode_chunk_ms"] = float(np.mean(chunk_ms[1:]))   # the first also warms up
    row["decode_chunk_ms_each"] = chunk_ms
    pos = [DECODE_CONTEXT]
    tok = ctx[:, -1]

    def step():
        out, _ = models.decode_step(params, cache, tok, pos[0], cfg)
        pos[0] += 1
        return out

    row["decode_batch"], row["decode_context"] = Bd, DECODE_CONTEXT
    row["decode_step_ms"] = time_ms(step, DECODE_CALLS)
    kernels, by_name = device_profile(step, MODEL_PROFILED, label="models decode_step")
    row["decode_step_device_ms"] = sum(by_name.values()) / 1e3
    row["decode_step_device_kernels"] = kernels
    row["decode_step_idle_share"] = 1 - row["decode_step_device_ms"] / row["decode_step_ms"]
    row["decode_step_top_kernels"] = top_kernels(by_name)
    row["decode_step_bound_ms"] = row["param_bytes"] / HBM_BYTES_PER_S * 1e3
    if pos[0] > DECODE_MAX_LEN:
        raise SystemExit(f"models decode_step: ran to position {pos[0]} past the cache")
    torch.cuda.synchronize()
    row["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    row["card"] = smi
    print(f"models {MODEL_ARCH} bf16 {cfg.moe_impl}: forward {B}x{S} {row['forward_ms']:.2f} ms "
          f"({row['forward_tokens_per_s']:.0f} tokens/s), device {row['forward_device_ms']:.2f} ms "
          f"in {row['forward_device_kernels']:.0f} kernels; decode_chunk of "
          f"{DECODE_CHUNK} {row['decode_chunk_ms']:.2f} ms; decode_step at {Bd} over "
          f"{DECODE_CONTEXT} tokens {row['decode_step_ms']:.2f} ms, device "
          f"{row['decode_step_device_ms']:.3f} ms in {row['decode_step_device_kernels']:.0f} "
          f"kernels, idle share {row['decode_step_idle_share']:.3f}; params "
          f"{row['param_bytes']} bytes, peak allocated {row['peak_allocated_bytes']} bytes ({smi})")
    return row


def zero_launches():
    """Set every launch count the kernels line reads to 0: each hand-written
    kernel's counter and the generated kernels' tally by emitter."""
    from repro_torch.core.codegen import KernelProgram
    from repro_torch.kernels import ops

    for kern in ops.KERNELS.values():
        kern.launches = 0
    for emitter in KernelProgram.launches_by_emitter:
        KernelProgram.launches_by_emitter[emitter] = 0


def read_launches(label):
    """Every kernel's launches since ``zero_launches``, by the kernels
    line's names; ``label``'s path launches none of them."""
    import torch

    from repro_torch.core.codegen import KernelProgram
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    launches = {**KernelProgram.launches_by_emitter,
                **{name: kern.launches for name, kern in ops.KERNELS.items()}}
    if any(launches.values()):
        raise SystemExit(f"{label}: the path launched the port's kernels {launches}")
    return launches


def models_phase(dev, smi):
    """Phase 13: the models on the card (see the module docstring).  Every
    kernel's launch count, hand-written and generated, is set to 0 just
    before and read just after: the models' path launches none of them.
    Returns the models line's object and each kernel's launches."""
    zero_launches()
    families = family_checks(dev)
    checks = granite_checks(dev)
    times = granite_times(dev, smi)
    launches = read_launches("models")
    return {"families": families, "granite_checks": checks, **times,
            "tolerances": {"family_f32": FAMILY_TOL, "granite_card_vs_cpu_f32": GRANITE_CPU_TOL,
                           "decode_vs_forward_f32": DECODE_TOL, "paged_vs_slot": "bitwise"}}, launches


# ---- phase 14: serving -------------------------------------------------------------
#: (a) each family at reduced_config: a small seeded trace, card (replayed)
#: against CPU (eager); Whisper through the slot engine, whose paged cache raises
FAMILY_TRACE = dict(num_requests=6, mean_interarrival_ticks=1.0, prompt_len_lo=3,
                    prompt_len_hi=12, max_new_lo=3, max_new_hi=6, seed=1)
FAMILY_PAGED = dict(decode_width=4, max_len=32, block_size=4, prefill_chunk=4)
FAMILY_SLOT = dict(pool_size=4, max_len=32, prefill_chunk=4)
#: (b) paged against slot at one width and a max_len of 2 x 16 - 1: the slot
#: ring's W + 1 = 32 slots equal the paged view's 2 blocks of 16, so both read
#: views have one shape; the prompt lengths and chunks of the reference's
#: test_paged_matches_slot_engine_single_request
PARITY_WIDTH, PARITY_MAX_LEN, PARITY_BLOCK, PARITY_NEW = 2, 31, 16, 6
PARITY_PROMPTS = ((1, 4), (3, 4), (7, 4), (12, 8), (17, 4))
#: preemption-resume: a pool of one max-length context (2 blocks), two
#: 12-token prompts of 16 new tokens each, as test_preemption_resume_token_parity
PREEMPT_PROMPTS = ((1, 13), (20, 32))
PREEMPT_NEW = 16
#: (c) one seeded Poisson trace through the paged engine, eager then replayed
SERVE_TRACE = dict(num_requests=16, mean_interarrival_ticks=2, prompt_len_lo=16,
                   prompt_len_hi=64, max_new_lo=8, max_new_hi=16, seed=0)
SERVE_ENGINE = dict(decode_width=8, max_len=255, block_size=16, prefill_chunk=16)
SERVE_DECODE_CALLS = 10     # timed decode launches (CUDA events), after as many warm
SERVE_PREFILL_CALLS = 5     # prefill launches timed one by one (median), after one warm
SERVE_POSITION = 128        # every row's position in the timed launches
#: (d) the entry point at full width
SERVE_ARGV = ["--arch", MODEL_ARCH, "--requests", "8"]


def serve_trace(eng, trace):
    """``run_trace`` of ``trace`` through ``eng``: the report and each
    request's tokens by rid (the harness makes the requests)."""
    from repro_torch import serve

    reqs = {}
    admit = eng.admit

    def keep(req):
        reqs[req.rid] = req
        return admit(req)

    eng.admit = keep
    rep = serve.run_trace(eng, trace, max_ticks=20_000, strict=True)
    del eng.admit
    return rep, {rid: r.out_tokens for rid, r in reqs.items()}


def engine_counters(stats):
    """Every ``stats()`` entry but the times, the graphs' own keys and the
    process-wide step cache: the reference's counters."""
    return {k: v for k, v in stats.items()
            if k not in ("graph_captures", "graph_replays", "graphs", "decode_cache")}


def graphs_replayed(label, eng):
    """The engine replayed its steps: each captured once, one replay a launch."""
    st = eng.stats()
    launches = st["prefill_launches"] + st["decode_launches"]
    if not eng.replay or st["graph_replays"] != launches or st["graph_captures"] < 1:
        raise SystemExit(f"serve {label}: replay {eng.replay}, {st['graph_captures']} captures, "
                         f"{st['graph_replays']} replays for {launches} launches")


def serve_families(dev):
    """(a): each architecture at reduced_config, f32: the card's replayed
    engine against the CPU's eager engine on one seeded trace, tokens and
    counters."""
    from repro_torch import models, serve
    from repro_torch.configs import ARCHITECTURES, get_config, reduced_config
    from repro_torch.models.module import tree_map

    rows = []
    for arch in sorted(ARCHITECTURES):
        cfg = reduced_config(get_config(arch))
        cpu = models.init_params(cfg, 0, device="cpu")
        card = tree_map(lambda t: t.to(dev), cpu)
        trace = serve.generate_trace(serve.TraceConfig(vocab_size=cfg.vocab_size, **FAMILY_TRACE))
        runs = {}
        for where, params in (("cpu", cpu), ("card", card)):
            if cfg.family == "audio":
                eng = serve.ServeEngine(cfg, params, device=params["embed"]["tok"].device,
                                        **FAMILY_SLOT)
            else:
                eng = serve.PagedServeEngine(cfg, params, device=params["embed"]["tok"].device,
                                             **FAMILY_PAGED)
            rep, toks = serve_trace(eng, trace)
            runs[where] = (toks, engine_counters(eng.stats()), rep)
        graphs_replayed(arch, eng)
        (ctoks, cst, _), (gtoks, gst, rep) = runs["cpu"], runs["card"]
        if gtoks != ctoks or gst != cst:
            bad = [rid for rid in ctoks if gtoks.get(rid) != ctoks[rid]]
            raise SystemExit(f"serve {arch}: card (replayed) vs cpu (eager): requests {bad} differ, "
                             f"counters equal {gst == cst}")
        rows.append({"arch": arch, "engine": type(eng).__name__, "requests": rep.completed,
                     "tokens": rep.tokens_out, "ticks": rep.ticks})
        print(f"serve {arch}: reduced f32 {type(eng).__name__}, card replayed vs cpu eager: "
              f"{rep.completed} requests, {rep.tokens_out} tokens, {rep.ticks} ticks, tokens "
              "and counters equal")
    return rows


def serve_parity(cfg, params, dev):
    """(b) at full width: paged against slot for single requests, and
    preemption-resume against solo runs, tokens bit for bit."""
    import numpy as np

    from repro_torch import serve

    def solo_runs(make, prompts, n):
        eng = make()
        out = []
        for p in prompts:
            r = serve.Request(rid=len(out), prompt=p, max_new_tokens=n)
            eng.admit(r)
            if eng.run_until_done() != 0:
                raise SystemExit("serve parity: a request did not finish")
            out.append(r.out_tokens)
        graphs_replayed("parity", eng)
        return out

    rows = []
    for chunk in sorted({c for _, c in PARITY_PROMPTS}):
        prompts = [(np.arange(n) % 100 + 1).astype(np.int32) for n, c in PARITY_PROMPTS if c == chunk]
        slot = solo_runs(lambda: serve.ServeEngine(
            cfg, params, pool_size=PARITY_WIDTH, max_len=PARITY_MAX_LEN, prefill_chunk=chunk,
            device=dev), prompts, PARITY_NEW)
        paged = solo_runs(lambda: serve.PagedServeEngine(
            cfg, params, decode_width=PARITY_WIDTH, max_len=PARITY_MAX_LEN,
            block_size=PARITY_BLOCK, prefill_chunk=chunk, device=dev), prompts, PARITY_NEW)
        for p, a, b in zip(prompts, slot, paged, strict=True):
            if a != b:
                raise SystemExit(f"serve paged vs slot, prompt {len(p)} chunk {chunk}: {b} vs {a}")
            rows.append({"prompt": len(p), "chunk": chunk, "tokens": a})
    prompts = [np.arange(lo, hi, dtype=np.int32) for lo, hi in PREEMPT_PROMPTS]
    solo = solo_runs(lambda: serve.ServeEngine(
        cfg, params, pool_size=PARITY_WIDTH, max_len=PARITY_MAX_LEN, prefill_chunk=4,
        device=dev), prompts, PREEMPT_NEW)
    eng = serve.PagedServeEngine(cfg, params, decode_width=PARITY_WIDTH, max_len=PARITY_MAX_LEN,
                                 block_size=PARITY_BLOCK, num_blocks=-(-PARITY_MAX_LEN // PARITY_BLOCK),
                                 prefill_chunk=4, device=dev)
    reqs = [serve.Request(rid=i, prompt=p, max_new_tokens=PREEMPT_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.admit(r)
    if eng.run_until_done(max_ticks=1000) != 0 or eng.sched.preemptions == 0:
        raise SystemExit(f"serve preemption: unfinished or {eng.sched.preemptions} preemptions")
    graphs_replayed("preemption", eng)
    if [r.out_tokens for r in reqs] != solo:
        raise SystemExit(f"serve preemption-resume: {[r.out_tokens for r in reqs]} vs solo {solo}")
    eng.allocator.check_consistent()
    print(f"serve {MODEL_ARCH} bf16: paged vs slot at width {PARITY_WIDTH}, max_len "
          f"{PARITY_MAX_LEN}, blocks of {PARITY_BLOCK}: {len(rows)} single requests bit for bit; "
          f"preemption-resume ({eng.sched.preemptions} preemptions) equals the solo runs")
    return {"paged_vs_slot": rows, "preemptions": eng.sched.preemptions, "preempt_tokens": solo}


def serve_numbers(cfg, params, dev, smi):
    """(b) replayed against eager and (c) the numbers, on one trace."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import models, serve

    trace = serve.generate_trace(serve.TraceConfig(vocab_size=cfg.vocab_size, **SERVE_TRACE))
    runs = {}
    for mode, replay in (("eager", False), ("replayed", True)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = serve.PagedServeEngine(cfg, params, **SERVE_ENGINE, device=dev, replay=replay)
        t0 = time.perf_counter()
        rep, toks = serve_trace(eng, trace)
        wall = time.perf_counter() - t0
        if rep.completed != rep.total:
            raise SystemExit(f"serve {mode}: {rep.completed} of {rep.total} requests finished")
        st = eng.stats()
        if replay:
            graphs_replayed(mode, eng)
        row = {"trace_s": wall, "report": dataclasses.asdict(rep), "counters": engine_counters(st),
               "graphs": st["graphs"], "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
        # a decode and a prefill launch with every row active, timed and profiled
        W, C = eng.width, eng.prefill_chunk
        rng = np.random.RandomState(7)
        table = (np.arange(eng._table.size) % eng.num_blocks).reshape(eng._table.shape).astype(np.int32)
        pos = np.full(W, SERVE_POSITION, np.int32)
        act = np.ones(W, bool)
        toks_v = rng.randint(0, cfg.vocab_size, W).astype(np.int32)
        toks_m = rng.randint(0, cfg.vocab_size, (W, C)).astype(np.int32)
        lens = np.full(W, C, np.int32)

        def decode():
            return eng._steps[0](toks_v, pos, act, table)

        def prefill():
            return eng._steps[1](toks_m, pos, act, lens, table)

        row["decode_launch_ms"] = time_ms(decode, SERVE_DECODE_CALLS)
        kernels, by_name = device_profile(decode, MODEL_PROFILED, label=f"serve {mode} decode")
        row["decode_device_ms"] = sum(by_name.values()) / 1e3
        row["decode_device_kernels"] = kernels
        row["decode_idle_share"] = 1 - row["decode_device_ms"] / row["decode_launch_ms"]
        row["decode_top_kernels"] = top_kernels(by_name)
        prefill()
        row["prefill_launch_ms_each"] = [time_ms(prefill, 1, warm=False)
                                         for _ in range(SERVE_PREFILL_CALLS)]
        row["prefill_launch_ms"] = float(np.median(row["prefill_launch_ms_each"]))
        runs[mode] = (row, toks)
        del eng
    (erow, etoks), (grow, gtoks) = runs["eager"], runs["replayed"]
    if gtoks != etoks or grow["counters"] != erow["counters"]:
        bad = [rid for rid in etoks if gtoks.get(rid) != etoks[rid]]
        raise SystemExit(f"serve replayed vs eager: requests {bad} differ, counters equal "
                         f"{grow['counters'] == erow['counters']}")
    bound_ms = models.tree_bytes(params) / HBM_BYTES_PER_S * 1e3
    for mode, (row, _) in runs.items():
        rep = row["report"]
        print(f"serve {MODEL_ARCH} bf16 paged {mode}: {rep['completed']} requests, "
              f"{rep['tokens_out']} tokens in {rep['ticks']} ticks, {rep['duration_s']:.3f} s: "
              f"{rep['tokens_per_s']:.1f} tokens/s; TTFT p50/p99 {rep['ttft_p50_ms']:.1f}/"
              f"{rep['ttft_p99_ms']:.1f} ms; latency p50/p99 {rep['latency_p50_ms']:.1f}/"
              f"{rep['latency_p99_ms']:.1f} ms; decode launch {row['decode_launch_ms']:.3f} ms "
              f"(device {row['decode_device_ms']:.3f} ms in {row['decode_device_kernels']:.0f} "
              f"kernels, idle share {row['decode_idle_share']:.3f}, bound {bound_ms:.3f}); prefill "
              f"launch of {SERVE_ENGINE['prefill_chunk']} {row['prefill_launch_ms']:.2f} ms (median "
              f"of {[round(t, 2) for t in row['prefill_launch_ms_each']]}); "
              f"max inflight {rep['max_inflight']}, KV peak {rep['kv_peak_utilization']:.3f}; "
              f"peak allocated {row['peak_allocated_bytes']} bytes; graphs {row['graphs']} ({smi})")
    print(f"serve {MODEL_ARCH}: replayed vs eager on one trace: every request's tokens bit for "
          f"bit, counters equal ({erow['counters']['ticks']} ticks, "
          f"{erow['counters']['prefill_launches']} prefill and "
          f"{erow['counters']['decode_launches']} decode launches, "
          f"{erow['counters']['preemptions']} preemptions)")
    return {"eager": erow, "replayed": grow, "decode_bound_ms": bound_ms}


def serve_phase(dev, smi):
    """Phase 14: serving on the card (see the module docstring).  Every
    kernel's launch count, hand-written and generated, is set to 0 just
    before and read just after: the serving path launches none of them.
    Returns the serve line's object and each kernel's launches."""
    import gc

    import torch

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve

    zero_launches()
    seconds = {}
    t0 = time.perf_counter()
    families = serve_families(dev)
    seconds["families"] = time.perf_counter() - t0
    cfg = get_config(MODEL_ARCH)
    params = models.init_params(cfg, 0, device=dev)
    t1 = time.perf_counter()
    parity = serve_parity(cfg, params, dev)
    seconds["parity"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    numbers = serve_numbers(cfg, params, dev, smi)
    seconds["numbers"] = time.perf_counter() - t1
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    if launch_serve.main(SERVE_ARGV) != 0:
        raise SystemExit(f"serve: python -m repro_torch.launch.serve {' '.join(SERVE_ARGV)} left "
                         "requests unfinished")
    seconds["entry_point"] = time.perf_counter() - t1
    launches = read_launches("serve")
    seconds["phase"] = time.perf_counter() - t0
    print(f"serve: launch.serve {' '.join(SERVE_ARGV)} finished every request; seconds "
          f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    return {"families": families, "parity": parity, **numbers, "seconds": seconds,
            "card": smi}, launches


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
    # phase 12: the frontend's functions and the families' hand-built graphs
    cases = frontend_cases()
    extra += frontend_sources(cases)
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
        _, by_name = profiled_launches(f"stitched compile {label}",
                                       lambda p=kernel.fn, a=a: p.launch(*a, device=dev),
                                       {kernel.fn.name: 1}, total=1)
        device_us = sum(t for k, t in by_name.items() if kernel.fn.name in k)
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
        _, by_name = profiled_launches(f"{emitter} compile {label}", lambda c=compiled, f=feeds: c(f),
                                       planned_by_program(compiled))
        device_us = sum(t for k, t in by_name.items() if any(nm in k for nm in names))
        extra_rows.append({"compile": label, "emitter": emitter, "kernels": names, "launches": n,
                           "max_abs_err": err, "tolerance": tol, "device_us": device_us,
                           "workspace_bytes": [k.fn.workspace_bytes for k in compiled.kernels]})
        print(f"{emitter} compile {label}: {n} launches, vs plain and reference_execute "
              f"err={err:.2e} (rtol, atol)={tol} device_us={device_us or 'not measured'}")

    # ---- 5. numbers -------------------------------------------------------------
    for row, (prog, a) in zip(rows, timed, strict=True):
        row["us"] = 1e3 * time_ms(lambda p=prog, a=a: p.launch(*a, device=dev), CALLS)
        _, by_name = profiled_launches(f"kernel {row['graph']}:{row['fusion']}",
                                       lambda p=prog, a=a: p.launch(*a, device=dev),
                                       {prog.name: 1}, total=1)
        row["device_us"] = sum(t for k, t in by_name.items() if prog.name in k)
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
        seen, by_name = profiled_launches(f"graph {name}", lambda c=compiled, f=dfeeds: c(f),
                                          planned_by_program(compiled))
        device_us = sum(by_name.values())
        idle = 1.0 - device_us / us if device_us else None
        # the unfused path's device time: every device kernel its torch ops run
        ref_seen, ref_by_name = device_profile(
            lambda m=module, f=dfeeds: reference_execute(m, f, device=dev), PROFILED_CALLS,
            f"unfused {name}")
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

    # ---- 12. the frontend ---------------------------------------------------------
    frontend_rows, frontend_launches = frontend_phase(dev, cases)
    for entry in entries:
        # the hand-written kernels are not on the frontend's path: 0
        entry["frontend_launches"] = frontend_launches.get(entry["name"], 0)

    # ---- 13. the models -------------------------------------------------------------
    models_row, models_launches = models_phase(dev, smi)
    for entry in entries:
        # the models call no hand-written kernel and compile nothing: 0, as counted
        entry["models_launches"] = models_launches[entry["name"]]

    # ---- 14. serving -------------------------------------------------------------------
    serve_row, serve_launches = serve_phase(dev, smi)
    for entry in entries:
        # the serving path calls the models only: no hand-written kernel, no
        # compile; 0, as counted
        entry["serve_launches"] = serve_launches[entry["name"]]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "build_s": build_s, "ptxas": ptxas,
                       "graphs": per_graph, "kernels": rows, "emitters": entries,
                       "stitched_compiles": stitched_rows, "extra_compiles": extra_rows,
                       "hand_kernel_calls": hand_calls, "replay": replay_rows, "loops": loop_rows,
                       "autotune": autotune_rows, "fault_modules": fault_rows,
                       "frontend": frontend_rows, "models": models_row, "serve": serve_row,
                       "profile_retakes": RETAKES}, f, indent=1)
    print(f"profiles taken again: {sum(len(r['refused']) for r in RETAKES)} "
          f"({', '.join(r['label'] for r in RETAKES) or 'none'})")
    print(f"card: {smi}")
    print(json.dumps({"models": models_row}))
    print(json.dumps({"serve": serve_row}))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
