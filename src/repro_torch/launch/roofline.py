"""Roofline analysis from the dry-run records — the reference's
``repro/launch/roofline.py`` on the H100.

Per (arch x shape) on the single-pod mesh, three terms in SECONDS:

    compute    = FLOPs / (chips x peak)          peak = 989 TF/s dense bf16
    memory     = bytes / (chips x 3.35 TB/s HBM)
    collective = collective_bytes / (chips x 900 GB/s NVLink)

FLOPs and bytes come from ``launch/costmodel.py`` (global logical costs,
counted as the ops dispatch); collective bytes from ``launch/hlostats.py``
(the census of rank 0's function).  The dominant term is the bottleneck;
MODEL_FLOPS = 6·N·D (train, dense), 6·N_active·D (MoE), 2·N·D (inference),
and MODEL_FLOPS / counted FLOPs exposes remat and redundancy.  The
constants derive from ``core.latency.H100``; ``analyze`` takes another
``DeviceSpec`` (the reference's ``TPU_V5E``) for parity with the reference.

    PYTHONPATH=src python -m repro_torch.launch.roofline --dir experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

from ..configs import SHAPES, get_config
from ..core.latency import H100, DeviceSpec, LatencyModel

_MODEL = LatencyModel(H100)
PEAK_FLOPS = H100.peak_flops_bf16     # dense bf16 per card
HBM_BW = H100.hbm_bw                  # per card
ICI_BW = H100.ici_bw                  # NVLink per card, both directions


def model_flops(arch: str, shape_name: str, shape: Optional[Dict] = None) -> float:
    """6·N·D (train), 2·N·D (prefill), 2·N·B (decode); ``shape`` (seq_len,
    global_batch, kind) stands for a cell outside ``SHAPES``."""
    cfg = get_config(arch)
    sh = shape or SHAPES[shape_name]
    B, S, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    n = cfg.active_param_count_estimate()
    if kind == "train":
        return 6.0 * n * B * S
    if kind == "prefill":
        return 2.0 * n * B * S
    return 2.0 * n * B        # decode: one token per sequence


def analyze(rec: Dict, spec: DeviceSpec = H100) -> Optional[Dict]:
    if "skip" in rec or "error" in rec:
        return None
    model = _MODEL if spec is H100 else LatencyModel(spec)
    chips = rec["num_devices"]
    flops = rec["flops"]
    byts_hi = rec["bytes_accessed"]
    byts_lo = rec.get("bytes_min", byts_hi)
    byts = (byts_lo * byts_hi) ** 0.5 if byts_lo else byts_hi  # geo-mean est.
    coll = sum(rec.get("collective_bytes", {}).values())
    t_c = model.compute_time(flops, chips)
    t_m = model.memory_time(byts, chips)
    t_x = model.collective_time(coll, chips)
    dominant = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))[1]
    mf = model_flops(rec["arch"], rec["shape"], rec.get("shape_spec"))
    bound = max(t_c, t_m, t_x)
    # roofline fraction: useful-model-FLOP time over the bound time
    useful_t = model.compute_time(mf, chips)
    return {
        **rec,
        "t_compute_s": t_c,
        "t_memory_s": t_m,
        "t_memory_lo_s": model.memory_time(byts_lo, chips),
        "t_memory_hi_s": model.memory_time(byts_hi, chips),
        "t_collective_s": t_x,
        "dominant": dominant,
        "model_flops": mf,
        "useful_ratio": mf / flops if flops else 0.0,
        "roofline_fraction": useful_t / bound if bound else 0.0,
    }


def _advice(row: Dict) -> str:
    d = row["dominant"]
    if d == "memory":
        if row["shape"].startswith("decode") or row["shape"].startswith("long"):
            return "decode is weight/cache-bandwidth bound: batch more requests per chip or quantize KV/weights"
        return "reduce activation re-reads: larger fused kernels (stitching), bf16 stash, fewer remat passes"
    if d == "compute":
        if row["useful_ratio"] < 0.6:
            return "compute includes remat recompute: relax remat policy / save dots"
        return "near compute roof: raise tensor-core utilization via tile-aligned shapes"
    return "collective-bound: overlap reduce-scatter with backward, compress grads, reorder sharding axes"


def build_table(dir_: str, mesh: str = "16x16") -> List[Dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("mesh") != mesh:
            continue
        rows.append(analyze(rec) or rec)
    return rows


def to_markdown(rows: List[Dict]) -> str:
    out = [
        "| arch | shape | t_compute | t_memory | t_collective | dominant | "
        "MODEL_FLOPS | useful | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if "skip" in r:
            out.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | skip | — | — | "
                f"{r['skip'].split(':')[0]} |"
            )
            continue
        if "error" in r:
            out.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | | | |")
            continue
        out.append(
            "| {arch} | {shape} | {tc:.2e} s | {tm:.2e} s | {tx:.2e} s | "
            "**{dom}** | {mf:.2e} | {ur:.2f} | {rf:.3f} |".format(
                arch=r["arch"], shape=r["shape"], tc=r["t_compute_s"],
                tm=r["t_memory_s"], tx=r["t_collective_s"], dom=r["dominant"],
                mf=r["model_flops"], ur=r["useful_ratio"],
                rf=r["roofline_fraction"],
            )
        )
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    rows = build_table(args.dir, args.mesh)
    print(to_markdown(rows))
    print()
    for r in rows:
        if "dominant" in r:
            print(f"{r['arch']:>24s} x {r['shape']:<12s}: {_advice(r)}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
