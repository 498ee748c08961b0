"""Training launcher (the reference's ``repro.launch.train`` over
``repro_torch``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 100 --batch 8 --seq 64 [--accum 1] [--lr 3e-4] [--reduced] \\
        [--ckpt-dir checkpoints] [--device cuda|cpu]

It runs on the card unless ``--device cpu`` asks for the CPU: there each
train step is captured once into a CUDA graph and replayed
(``CapturedTrainStep``); on the CPU it runs eagerly.  The reduced config
is used under ``--reduced`` or on the CPU, as the reference uses it on
JAX's CPU backend.  ``--mesh`` (the reference's pjit-sharded step) raises
``NotImplementedError`` until sharding is ported.  Checkpoints go to
``--ckpt-dir`` every 50 steps and at the end; a rerun resumes from the
newest.  Exits 0 when every step's loss is finite, 1 otherwise.
"""
from __future__ import annotations

import argparse
import math
import sys

from ..checkpoint import CheckpointManager
from ..configs import get_config, reduced_config
from ..core.device import resolve_device
from ..core.ir import SHARDING_ITEM
from ..data import SyntheticLM
from ..models import count_params, init_params
from ..train import AdamWConfig, CapturedTrainStep, Trainer, TrainerConfig, make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale reduced config (the default on the CPU)")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--mesh", default=None,
                    help="data,model e.g. 16,16: not ported yet (raises)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            f"--mesh {args.mesh} (a sharded train step over a device mesh) is ported by "
            f"{SHARDING_ITEM}")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced or dev.type == "cpu":
        cfg = reduced_config(cfg)
        print(f"[train] reduced config for {args.arch} on {dev}")

    params = init_params(cfg, seed=0, device=dev)
    print(f"[train] params: {count_params(params):,}")
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                       total_steps=args.steps)
    train_step = make_train_step(cfg, ocfg, accum_steps=args.accum)
    if dev.type == "cuda":
        train_step = CapturedTrainStep(train_step, dev)
    tcfg = TrainerConfig(total_steps=args.steps, checkpoint_every=50)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)

    trainer = Trainer(
        cfg, ocfg, tcfg,
        lambda start: SyntheticLM(cfg, args.seq, args.batch, seed=0).iterate(start),
        ckpt, train_step=train_step, device=dev,
    )
    params, _, step = trainer.run(params)
    losses = [h["loss"] for h in trainer.history]
    if losses:
        print(f"[train] done at step {step}; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return 0 if all(math.isfinite(x) for x in losses) else 1


if __name__ == "__main__":
    sys.exit(main())
