"""Serving launcher: batched decode on a selected architecture (the
reference's ``repro.launch.serve`` over ``repro_torch``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --requests 8 --max-new 16 [--reduced] [--engine paged|slot] \\
        [--block-size 16] [--num-blocks N] [--ttft-slo-ms 50] \\
        [--device cuda|cpu] [--no-replay]

It runs on the card unless ``--device cpu`` asks for the CPU, with each
engine step replayed from a CUDA graph unless ``--no-replay``.  The
reduced config is used under ``--reduced`` or on the CPU, as the
reference uses it on JAX's CPU backend.  Exits 0 when every request
finished, 1 otherwise.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..configs import get_config, reduced_config
from ..core.device import resolve_device
from ..models import count_params, init_params
from ..serve import PagedServeEngine, Request, ServeEngine, SLOConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--engine", choices=("paged", "slot"), default="paged",
                    help="paged = continuous batching over KV blocks "
                    "(default); slot = contiguous per-slot rings")
    ap.add_argument("--pool", type=int, default=4,
                    help="slot engine: batch slots; paged engine: decode "
                    "width (rows per batched launch)")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt tokens per prefill launch (1 = per-token)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged engine: tokens per KV block")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="paged engine: total KV blocks (default: "
                    "pool * ceil(ring/block_size), i.e. no memory pressure)")
    ap.add_argument("--ttft-slo-ms", type=float, default=None,
                    help="paged engine: prioritize prefill when a request's "
                    "projected TTFT would overrun this")
    ap.add_argument("--decode-slo-ms", type=float, default=None,
                    help="paged engine: force a decode launch when the gap "
                    "since the last one exceeds this")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--no-replay", action="store_true",
                    help="run each engine step eagerly instead of replaying "
                    "its CUDA graph")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced or dev.type == "cpu":
        cfg = reduced_config(cfg)
    params = init_params(cfg, seed=0, device=dev)
    replay = False if args.no_replay else None
    if args.engine == "paged":
        slo = None
        if args.ttft_slo_ms is not None or args.decode_slo_ms is not None:
            slo = SLOConfig(
                ttft_slo_s=(args.ttft_slo_ms / 1e3
                            if args.ttft_slo_ms is not None else None),
                decode_slo_s=(args.decode_slo_ms / 1e3
                              if args.decode_slo_ms is not None else None),
            )
        engine = PagedServeEngine(
            cfg, params, decode_width=args.pool, max_len=args.max_len,
            block_size=args.block_size, num_blocks=args.num_blocks,
            prefill_chunk=args.prefill_chunk, slo=slo, device=dev,
            replay=replay,
        )
        kv = (f"blocks={engine.num_blocks}x{engine.block_size}"
              if engine.allocator is not None else "no-kv(ssm)")
        print(f"[serve] {cfg.name}: {count_params(params):,} params, "
              f"paged width={args.pool}, max_len={args.max_len}, {kv}, "
              f"prefill_chunk={args.prefill_chunk}, {dev}, "
              f"replay={engine.replay}")
    else:
        engine = ServeEngine(cfg, params, pool_size=args.pool,
                             max_len=args.max_len,
                             prefill_chunk=args.prefill_chunk, device=dev,
                             replay=replay)
        print(f"[serve] {cfg.name}: {count_params(params):,} params, "
              f"slot pool={args.pool}, max_len={args.max_len}, "
              f"prefill_chunk={args.prefill_chunk}, {dev}, "
              f"replay={engine.replay}")
    rng = np.random.RandomState(0)
    reqs = [
        Request(rid=i, prompt=rng.randint(1, cfg.vocab_size, size=rng.randint(4, 12)),
                max_new_tokens=args.max_new)
        for i in range(args.requests)
    ]
    t0 = time.perf_counter()
    # admit() parks overflow on the engine's FIFO wait queue; ticks drain it
    for r in reqs:
        engine.admit(r)
    remaining = engine.run_until_done(max_ticks=20_000)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens or []) for r in reqs)
    for r in reqs:
        print(f"[req {r.rid:3d}] prompt={len(r.prompt):3d} "
              f"new={len(r.out_tokens or []):3d} "
              f"wait={1e3 * (r.queue_wait_s or 0):7.1f}ms "
              f"ttft={1e3 * (r.ttft_s or 0):7.1f}ms "
              f"latency={1e3 * (r.latency_s or 0):7.1f}ms "
              f"tok/s={r.tokens_per_s or 0:6.1f}")
    st = engine.stats()
    print(f"[serve] {sum(r.done for r in reqs)}/{len(reqs)} done "
          f"({remaining} unfinished), "
          f"{toks} tokens in {dt:.2f}s ({toks/dt:.1f} tok/s)")
    print(f"[serve] launches: prefill={st['prefill_launches']} "
          f"(per-token would be {st['prefill_tokens']}), "
          f"decode={st['decode_launches']}; "
          f"decode_cache={st['decode_cache']}; "
          f"graphs captured={st['graph_captures']} "
          f"replays={st['graph_replays']}")
    if "kv_blocks" in st:
        kv = st["kv_blocks"]
        print(f"[serve] kv blocks: peak={kv['peak_in_use']}/{kv['num_blocks']} "
              f"(util {kv['peak_utilization']:.2f}), "
              f"alloc={kv['allocated_total']} freed={kv['freed_total']} "
              f"preemptions={st['preemptions']} "
              f"max_inflight={st['max_inflight']}")
    return 0 if remaining == 0 and all(r.done for r in reqs) else 1


if __name__ == "__main__":
    sys.exit(main())
