#!/usr/bin/env python3
"""Device times of the port's kernels in several checkouts, in turns, on one card.

    python3 kernel_ab.py [--rounds N] [--out PATH] DIR [DIR ...]

Each DIR is the root of a checkout of this repository, for instance a
``git archive`` of the parent commit and one of the change, unpacked into
``build/``.  Round r runs every checkout once, in the given order on even
rounds and reversed on odd ones (A B, B A, ...), each in a process of its
own that imports that checkout's ``repro_torch`` and builds its kernels
into that checkout's ``build/``.  A run prints one JSON line: the checkout,
nvidia-smi's SM clock, power draw and temperature just before, and
torch.profiler's device microseconds per call (20 calls after 50 warm-up
calls) of each hand-written kernel of ``repro_torch.kernels.ops`` at the
full-width shapes of ``chip_smoke.py`` phase 6 and of every generated kernel
of the ten graphs (``GRAPH:FUSION``: the 19 unique ``emit_fusion`` kernels
and StitchPipe's stitched one, ``emit_stitched_fusion``, on the inputs one
call of its graph gives it), and each graph's device time per call: fused,
through the eager step loop (``graph-eager:GRAPH``, ``jit_replay=False``)
and replayed through its CUDA graph (``graph-replay:GRAPH``, a compile
with the default options, ``jit_execute``; only in a checkout that has
the replay), and unfused through ``reference_execute``
(``unfused:GRAPH``), and the generated kernel of ``repro_torch.stitch``
over ``F.silu(a) * b`` (qwen2.5-14b's MLP activation: 512 tokens by 3456
columns, one of four ranks, and by 13824, unsharded) in bf16 and f32
(``silu_mul:DTYPE:COLS``), and of ``chip_smoke.model_width_cases``' four
functions at granite-moe-3b-a800m's width over 512 tokens
(``model:NAME``: rmsnorm, layer_stats, gated_mlp, the Figure-3 attention),
each through ``repro_torch.stitch`` under the checkout's default options,
so the parent's plan against the change's; each run gives their plan
blocks and CUDA blocks a kernel and holds their outputs against the plain
function at ``chip_smoke.TOL`` (failing past it).  The kernels' inputs are
recorded in the eager compile, so no copy of them is captured into a graph.  A run also gives
each silu x mul kernel's grid, threads and workspace bytes, and a SHA-256
of its output; the last line says whether every run's digest equals the
first run's (the outputs bit for bit across checkouts), and gives each
number's median over the rounds per checkout.  Exits non-zero when no
card is present.
"""
import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CALLS, WARMUP = 20, 50


def measure(root):
    """One run in checkout ``root``: device us per kernel, and each silu x
    mul kernel's launch and output digest."""
    import re

    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import GRANITE, TOL, model_width_cases  # root's src goes first

    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch import stitch
    from repro_torch.core import StitchOptions, compile_module, reference_execute
    from repro_torch.graphs import ALL_GRAPHS, random_feeds
    from repro_torch.kernels import ops

    if not os.path.abspath(ops.__file__).startswith(os.path.join(root, "src")):
        raise SystemExit(f"kernel_ab: imported {ops.__file__}, not the checkout {root}")

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)

    def randn(shape, dtype):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev).to(dtype)

    def device_us(fn, names=None):
        """Device us per call of the kernels whose names hold one of
        ``names`` (None: every device kernel the call runs).  The profiler
        drops a run's events now and then: a profile that sees no kernel
        is taken again, up to 4 times, then the run fails."""
        for _ in range(WARMUP):
            fn()
        for _ in range(4):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(CALLS):
                    fn()
                torch.cuda.synchronize()
            us = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and (names is None or any(n in e.name for n in names))]
            if us:
                return sum(us) / CALLS
        raise SystemExit(f"kernel_ab: the profiler saw no kernel of {names or 'the call'}")

    try:
        eager_opts = StitchOptions(jit_replay=False)
    except TypeError:     # a checkout from before the replay: every call is eager
        eager_opts = StitchOptions()

    # every generated kernel, on the inputs one call of its graph gives it
    calls = {}
    for gname, build in ALL_GRAPHS.items():
        module = build()
        compiled = compile_module(module, eager_opts, device=dev)
        feeds = {k: torch.as_tensor(v, device=dev)
                 for k, v in random_feeds(module, np.random.RandomState(0)).items()}
        captured = {}
        for k in compiled.kernels:
            def record(*a, device, _k=k, _launch=k.fn.launch):
                captured.setdefault(_k.fusion.name, (_k.fn, [t.clone() for t in a]))
                return _launch(*a, device=device)
            k.fn.launch = record
        compiled(feeds)
        for k in compiled.kernels:
            del k.fn.launch
        for fusion, (prog, a) in captured.items():
            calls[f"{gname}:{fusion}"] = (lambda p=prog, a=a: p.launch(*a, device=dev), (prog.name,))
        calls[f"graph-eager:{gname}"] = (lambda c=compiled, f=feeds: c(f), None)
        replayed = compile_module(module, device=dev).executable
        if hasattr(replayed, "jit_execute"):
            calls[f"graph-replay:{gname}"] = (lambda x=replayed, f=feeds: x.jit_execute(f), None)
        calls[f"unfused:{gname}"] = (lambda m=module, f=feeds: reference_execute(m, f, device=dev), None)

    # silu(a) * b through stitch, eager, its one generated kernel recorded
    silu_rng = np.random.RandomState(24)
    silu = {}
    for dtype, dname in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for cols in (3456, 13824):
            a, b = (torch.as_tensor(silu_rng.uniform(-4, 4, (512, cols)).astype(np.float32),
                                    device=dev).to(dtype) for _ in range(2))
            fn = stitch(lambda x, y: F.silu(x) * y, options=eager_opts, device=dev)
            fn(a, b)
            (k,) = fn._last.compiled.kernels
            seen = []

            def record(*xs, device, _launch=k.fn.launch):
                seen.append([t.clone() for t in xs])
                return _launch(*xs, device=device)

            k.fn.launch = record
            out = fn(a, b)
            del k.fn.launch
            torch.cuda.synchronize()
            launch = re.search(r"<<<(\d+), (\d+), ", k.fn.source)
            key = f"silu_mul:{dname}:{cols}"
            silu[key] = {"kernel": k.fn.name, "grid": int(launch[1]), "threads": int(launch[2]),
                         "workspace_bytes": k.fn.workspace_bytes,
                         "sha256": hashlib.sha256(out.contiguous().view(torch.uint8).cpu().numpy()
                                                  .tobytes()).hexdigest()}
            calls[key] = (lambda p=k.fn, xs=seen[0]: p.launch(*xs, device=dev), (k.fn.name,))

    # the four granite-width functions under the checkout's default plan
    model = {}
    for name, fn, args, _, _ in model_width_cases():
        dargs = [torch.as_tensor(a, device=dev) for a in args]
        st = stitch(fn, options=eager_opts, device=dev)
        out = st(*dargs)
        plain = fn(*dargs)
        torch.cuda.synchronize()
        err = float((out.double() - plain.double()).abs().max())
        if not bool(torch.isclose(out.double(), plain.double(), rtol=TOL, atol=TOL).all()):
            raise SystemExit(f"kernel_ab: model:{name} vs the plain function {err:.3e} (TOL {TOL})")
        shapes = []
        for k in st._last.compiled.kernels:
            head = re.search(r"(\d+) plan blocks(?: in all)?, (?:one launch of|one cooperative "
                             r"launch of up to) (\d+) blocks", k.fn.source)
            shapes.append({"fusion": k.fusion.name, "plan_blocks": int(head[1]),
                           "cuda_blocks": int(head[2]), "workspace_bytes": k.fn.workspace_bytes})
        model[f"model:{name}"] = {"max_abs_err": err, "kernels": shapes}
        calls[f"model:{name}"] = (lambda s=st, a=dargs: s(*a), None)

    g, bf16, f32 = GRANITE, torch.bfloat16, torch.float32
    x, gamma = randn((8, 512, g["d_model"]), bf16), randn((g["d_model"],), bf16)
    logits = randn((16, g["vocab"]), f32)
    S, D = 2048, g["head_dim"]
    q = randn((1, g["heads"], S, D), bf16)
    k, v = randn((1, g["kv_heads"], S, D), bf16), randn((1, g["kv_heads"], S, D), bf16)
    qd = randn((16, g["heads"], D), bf16)
    kc, vc = randn((16, g["kv_heads"], 4096, D), bf16), randn((16, g["kv_heads"], 4096, D), bf16)
    lengths = torch.as_tensor(rng.randint(1, 4097, size=16), dtype=torch.int32, device=dev)
    gl = randn((4096, g["experts"]), f32)
    calls.update({
        "stitched_rmsnorm": (lambda: ops.rmsnorm(x, gamma, eps=g["norm_eps"]), ("sx_rmsnorm",)),
        "stitched_softmax": (lambda: ops.softmax(logits), ("sx_softmax",)),
        "stitched_flash_attention": (lambda: ops.attention(q, k, v, causal=True), ("sx_flash",)),
        "stitched_decode_attention": (lambda: ops.attention_decode(qd, kc, vc, lengths), ("sx_decode",)),
        "stitched_moe_gate": (lambda: ops.moe_gate(gl, g["top_k"]), ("sx_moe_gate",)),
    })
    return {"device_us": {name: device_us(fn, names) for name, (fn, names) in calls.items()},
            "silu_mul": silu, "model_width": model}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--out", help="also write every run as JSON here")
    ap.add_argument("--measure", help=argparse.SUPPRESS)   # one run, in a process of its own
    ap.add_argument("dirs", nargs="*")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if args.measure:
        print(json.dumps(measure(os.path.abspath(args.measure))))
        return 0
    if not args.dirs:
        ap.error("name at least one checkout")
    smi = ["nvidia-smi", "--format=csv,noheader"]
    card = subprocess.run(smi + ["--query-gpu=name,power.limit"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    runs = []
    for r in range(args.rounds):
        for d in (args.dirs if r % 2 == 0 else args.dirs[::-1]):
            clocks = subprocess.run(smi + ["--query-gpu=clocks.sm,power.draw,temperature.gpu"],
                                    capture_output=True, text=True, check=True, timeout=60).stdout.strip()
            proc = subprocess.run([sys.executable, os.path.join(HERE, "kernel_ab.py"), "--measure",
                                   os.path.abspath(d)],
                                  capture_output=True, text=True, cwd=HERE, timeout=900)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                raise SystemExit(f"kernel_ab: the run in {d} failed with exit {proc.returncode}")
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            run = {"round": r, "checkout": d, "clocks": clocks, "device_us": got["device_us"],
                   "silu_mul": got["silu_mul"], "model_width": got["model_width"]}
            runs.append(run)
            print(json.dumps(run))
    medians = {}
    for d in args.dirs:
        mine = [run["device_us"] for run in runs if run["checkout"] == d]
        medians[d] = {k: statistics.median(us[k] for us in mine) for k in mine[0]}
    # the silu x mul outputs of every run against the first run's, bit for bit
    first = runs[0]["silu_mul"]
    same = {k: all(run["silu_mul"][k]["sha256"] == v["sha256"] for run in runs) for k, v in first.items()}
    launches = {d: next(run["silu_mul"] for run in runs if run["checkout"] == d) for d in args.dirs}
    plans = {d: next(run["model_width"] for run in runs if run["checkout"] == d) for d in args.dirs}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": runs, "medians": medians, "silu_mul_launches": launches,
                       "silu_mul_outputs_equal": same, "model_width_plans": plans}, f, indent=1)
    print(json.dumps({"card": card, "medians": medians, "silu_mul_launches": launches,
                      "silu_mul_outputs_equal": same, "model_width_plans": plans}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
