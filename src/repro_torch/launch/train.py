"""Training launcher (the reference's ``repro.launch.train`` over
``repro_torch``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 100 --batch 8 --seq 64 [--accum 1] [--lr 3e-4] [--reduced] \\
        [--ckpt-dir checkpoints] [--device cuda|cpu] [--mesh data,model]

It runs on the card unless ``--device cpu`` asks for the CPU: there each
train step is captured once into a CUDA graph and replayed
(``CapturedTrainStep``); on the CPU it runs eagerly.  The reduced config
is used under ``--reduced`` or on the CPU, as the reference uses it on
JAX's CPU backend.

``--mesh data,model`` is the reference's sharded step: every rank of a
``torch.distributed`` world of data x model ranks runs this program
(``torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2,2
...``; with no process group yet, the launcher starts one from torchrun's
environment: NCCL on the card, gloo on the CPU or for several ranks on one
card), builds ``make_smoke_mesh(data, model)``, places the state with
``reshard_state`` and trains with ``make_sharded_train_step``, eagerly.
Without such a world it raises, naming the world size it needs.  Rank 0
alone writes the checkpoints (the global leaves) and prints.

Checkpoints go to ``--ckpt-dir`` every 50 steps and at the end; a rerun
resumes from the newest.  Exits 0 when every step's loss is finite, 1
otherwise.
"""
from __future__ import annotations

import argparse
import math
import sys

from ..checkpoint import CheckpointManager
from ..configs import get_config, reduced_config
from ..core.device import resolve_device
from ..data import SyntheticLM
from ..models import count_params, init_params
from ..train import (
    AdamWConfig,
    CapturedTrainStep,
    Trainer,
    TrainerConfig,
    adamw_init,
    make_sharded_train_step,
    make_train_step,
)


def _world(data: int, model: int, dev):
    """The (data, model) mesh of the current world; a world is started from
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) when
    none is up.  Several ranks on one card run gloo (NCCL refuses them)."""
    import os

    import torch
    import torch.distributed as dist

    from .mesh import make_smoke_mesh

    need = data * model
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != need:
            raise RuntimeError(f"--mesh {data},{model} needs a world of {need} ranks; "
                               f"WORLD_SIZE is {os.environ['WORLD_SIZE']}")
        one_card = dev.type == "cuda" and torch.cuda.device_count() < need
        backend = "nccl" if dev.type == "cuda" and not one_card else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
        dist.init_process_group(backend)
    return make_smoke_mesh(data, model, device=dev)


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
                    help="data,model e.g. 2,2: the sharded step, one rank a mesh position")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = None
    if args.mesh:
        data, model = (int(x) for x in args.mesh.split(","))
        mesh = _world(data, model, dev)
        if dev.type == "cuda":
            import torch

            dev = torch.device("cuda", torch.cuda.current_device())
    lead = mesh is None or mesh.get_rank() == 0

    def say(msg):
        if lead:
            print(msg)

    cfg = get_config(args.arch)
    if args.reduced or dev.type == "cpu":
        cfg = reduced_config(cfg)
        say(f"[train] reduced config for {args.arch} on {dev}")

    params = init_params(cfg, seed=0, device=dev)
    say(f"[train] params: {count_params(params):,}")
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                       total_steps=args.steps)
    opt_state = None
    if mesh is not None:
        from ..distributed import reshard_state

        params, opt_state = reshard_state(params, adamw_init(params), mesh)
        train_step = make_sharded_train_step(cfg, ocfg, mesh, accum_steps=args.accum)
        say(f"[train] sharded over {args.mesh} (data, model)")
    else:
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
    params, _, step = trainer.run(params, opt_state)
    losses = [h["loss"] for h in trainer.history]
    if losses:
        say(f"[train] done at step {step}; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return 0 if all(math.isfinite(x) for x in losses) else 1


if __name__ == "__main__":
    sys.exit(main())
