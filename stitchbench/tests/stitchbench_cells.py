"""Small cells for the CPU tests: each configuration of ``BENCHMARK.json``
at widths of its own shape (the published head ratio on this chip, a
smaller head size, a narrower MLP), over two layers and a few short
sequences."""
import json
from pathlib import Path

from stitchbench import harness

BENCH = json.loads((Path(harness.HERE).parent / "BENCHMARK.json").read_text())
#: per configuration: (heads, kv heads, head_dim) of the whole layer, kept
#: in the published ratio, and the MLP's width where it has one
SMALL = {"granite-moe-3b-a800m.attn": (6, 2, 16, None),
         "mistral-large-123b.tp8": (96, 8, 8, 64)}


def small_cell(workload: str, batch: int = 2, seq: int = 24, layers: int = 2) -> harness.Cell:
    cell = harness.load_cell(workload, BENCH)
    base = cell.config["name"].removesuffix("-bf16")
    heads, kv, hd, ff = SMALL[base]
    tp = cell.config.get("tensor_parallel", 1)
    cell.config = dict(cell.config, num_attention_heads=heads, num_key_value_heads=kv,
                       head_dim=hd, hidden_size=heads // tp * hd * 2, num_hidden_layers=layers)
    if ff:
        cell.config["intermediate_size"] = ff
    cell.traffic = dict(cell.traffic, batch=batch, seq=seq)
    return cell


WORKLOADS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = {c["name"]: next(w["name"] for w in BENCH["workloads"] if w["config"] == c["name"])
           for c in BENCH["configs"]}
