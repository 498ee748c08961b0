"""One run of one benchmark cell: ``python3 stitchbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>``.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a configuration
(``configs/<config>.json``, which names its program) under a traffic mix
(``traffic/<traffic>.json``).  Everything that belongs to one
configuration, one traffic mix, one program or one metric sits in a file
of its own, found here by name:

* ``programs/<program>.py``: ``build(cfg, batch, seq)``, the layer handed to
  ``repro_torch.stitch``; ``args(cfg)``, its arguments after ``x``;
  ``make_inputs``; ``shape(cfg)``, the sizes this chip holds; ``WORK``, the
  counts of ``work.py`` that one request needs;
* ``reference/<program>.py``: ``forward(cfg, shape, seq, layers, x, cos,
  sin, precision)``, the plain PyTorch reference of the whole stack;
* ``metrics/<metric>.py``: ``read(run)``, the metric from a ``Run``, or
  None where the run has nothing for it to read;
* ``limits/<workload>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from.

The run makes the weights of every layer and ``distinct_inputs`` inputs on
the card from the seed, compiles the layer with ``repro_torch.stitch`` under
its default options (the card's plan, no fallback, the CUDA-graph replay)
and warms it up.  A request is one forward pass of a batch through every
layer: the stitched layer called once a layer with that layer's weights,
then ``torch.cuda.synchronize()``, as a prefill whose output is read next
would be.  The window is a closed loop of requests with one caller, for
``--seconds`` seconds (``--trace 0``) or under ``torch.profiler``
(``--trace 1``).  After the window the run frees the program and compares a
sample of the window's outputs, drawn from the seed, with the reference.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import random
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from stitchbench import trace

HERE = Path(__file__).resolve().parent
#: top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
#: outputs of the window kept for the comparison with the reference
SAMPLES = 4
#: the traced window: requests spanning about this many seconds, within bounds
TRACE_SECONDS = 2.0
TRACE_CALLS = (1, 400)
#: the control of each configuration type: the reference computed in the
#: nearest precision below it (``reference.forward``'s ``precision``)
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}
#: the longest idle gaps that are labelled by what the host was doing
LABELLED_GAPS = 500


@dataclass
class Cell:
    """One entry of ``workloads``, with what its names lead to."""

    name: str
    chips: int
    config: dict
    traffic: dict
    program: object
    reference: object
    metrics: List[dict]          # the end-to-end metrics the cell reports
    per_layer: List[dict]        # the per-layer metrics read in its traced runs
    limits: Dict[str, dict]
    root: Path = HERE            # the benchmark's folder, where its files are found

    @property
    def batch(self) -> int:
        return self.traffic["batch"]

    @property
    def seq(self) -> int:
        return self.traffic["seq"]

    @property
    def shape(self) -> dict:
        return self.program.shape(self.config)


@dataclass
class Run:
    """What metric readers read.  Times are host seconds unless named."""

    cell: Cell
    work: object
    setup_s: float = 0.0
    compile_s: float = 0.0
    calls: int = 0                                          # requests completed
    layers: int = 1                                         # stitched calls a request
    request_ms: List[float] = field(default_factory=list)  # each request, host clock
    enqueue_ms: List[float] = field(default_factory=list)  # of which the host enqueued
    window_s: float = 0.0
    # traced runs: the device events between the marks, the seconds in
    # which one ran, and the marks' span on the device's clock
    events: List[trace.Event] = field(default_factory=list)
    busy_s: float = 0.0
    device_window_s: float = 0.0


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(root: Path, kind: str, name: str):
    """``<root>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(f"stitchbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, bench: Optional[dict] = None, root: Path = HERE) -> Cell:
    """The cell named ``workload`` in ``BENCHMARK.json`` beside ``root``
    (or in ``bench``), its files found under ``root``."""
    bench = bench if bench is not None else _load_json(root.parent / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r}; have {sorted(entries)}")
    w = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root.parent / configs[w["config"]]["file"])
    traffic = _load_json(root / "traffic" / f"{w['traffic']}.json")
    program = config["program"]
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload]) and m["moves"] in moved]
    limits_path = root / "limits" / f"{workload}.json"
    return Cell(
        name=workload, chips=w["chips"], config=config, traffic=traffic,
        program=importlib.import_module(f"stitchbench.programs.{program}"),
        reference=importlib.import_module(f"stitchbench.reference.{program}"),
        metrics=e2e, per_layer=per_layer,
        limits=_load_json(limits_path)["limits"] if limits_path.is_file() else {},
        root=root,
    )


def read_metrics(specs: List[dict], run: Run) -> Dict[str, dict]:
    """Each metric's reader over ``run``; one that finds nothing is left out."""
    out = {}
    for m in specs:
        value = _module(run.cell.root, "metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def traffic_order(seed: int, distinct: int) -> List[int]:
    """The order in which a run's calls take its inputs, cycled: a
    permutation drawn from the seed, so every seed sends the same work."""
    order = list(range(distinct))
    random.Random(seed).shuffle(order)
    return order


class Reservoir:
    """A uniform sample of ``k`` of the outputs offered, drawn from a seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.kept = k, random.Random(seed ^ 0x5EED), 0, []

    def offer(self, item) -> None:
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.kept[j] = item
        self.seen += 1


def errors(cell: Cell, inputs, x, y, precision: str = "exact") -> Dict[str, float]:
    """Each number compared for ``y``, a request's output for ``x``: its
    ``out_err``, the widest gap from the reference's output over the widest
    change the reference's stack makes to ``x``.  ``inputs`` is
    ``make_inputs``' (layers, RoPE tables, xs).  A gap that is not finite
    reads infinite."""
    layers, (cos, sin), _ = inputs
    want = cell.reference.forward(cell.config, cell.shape, cell.seq, layers, x, cos, sin,
                                  precision)
    err = float((y.float() - want).abs().max()) / float((want - x.float()).abs().max())
    return {"out_err": err if math.isfinite(err) else math.inf}


def worst(readings) -> Dict[str, float]:
    """Each number's largest reading over ``readings``, dicts of ``errors``."""
    readings = list(readings)
    return {k: max(r[k] for r in readings) for k in readings[0]}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def compile_layer(cell: Cell, device, stitch: Optional[Callable] = None):
    """The cell's layer through ``stitch`` (``repro_torch.stitch`` unless
    given) under its default options, on the card or, for the tests, the
    CPU; TF32 off, as the port sets it."""
    if stitch is None:
        from repro_torch import stitch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fn = cell.program.build(cell.config, cell.batch, cell.seq)
    return stitch(fn) if device.type == "cuda" else stitch(fn, device="cpu")


def request(sf, inputs, i: int):
    """One request: input ``i`` through every layer, each layer's weights
    with the RoPE tables after ``x``; returns the last layer's output."""
    layers, tables, xs = inputs
    x = xs[i]
    for w in layers:
        x = sf(x, *w.values(), *tables)
    return x


def check_replay(sf, device) -> None:
    """The run's refusal of a plan that fell back or does not replay its
    CUDA graph (the CPU, where the tests drive a run, replays eagerly)."""
    mode = sf.stats.replay_mode
    if sf.num_fallbacks or mode != ("graph" if device.type == "cuda" else "eager"):
        raise RuntimeError(f"the plan fell back ({sf.num_fallbacks}) or does not replay its "
                           f"CUDA graph (replay_mode {mode!r})")


def control_readings(cell: Cell, seeds, device, stitch: Optional[Callable] = None):
    """For each seed, the program's ``errors`` over every input a run of
    that seed sends (each number's worst), through the layer the window
    drives (compiled once: the seeds share their shapes), and the
    control's: the reference in the precision below the configuration's
    (``CONTROL``), put in the program's place.  Yields (seed, program,
    control)."""
    sf = compile_layer(cell, device, stitch)
    precision = CONTROL[cell.shape["dtype"]]
    for seed in seeds:
        inputs = cell.program.make_inputs(cell.config, cell.batch, cell.seq, seed,
                                          cell.traffic["distinct_inputs"], device)
        got = [request(sf, inputs, i) for i in range(len(inputs[2]))]
        _sync(device)
        check_replay(sf, device)
        prog = worst(errors(cell, inputs, x, y) for x, y in zip(inputs[2], got))
        del got
        layers, (cos, sin), xs = inputs
        ctl = worst(errors(cell, inputs, x, cell.reference.forward(
            cell.config, cell.shape, cell.seq, layers, x, cos, sin, precision)) for x in xs)
        yield seed, prog, ctl
        del inputs, layers, xs
        if device.type == "cuda":
            torch.cuda.empty_cache()


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t0: float,
             stitch: Optional[Callable] = None) -> Tuple[dict, dict]:
    """One run; returns the result line's object (``checks`` last) and what
    standard error gets: the set-up's parts, the plan, the requests'
    quartiles and, traced, every device activity a request.  ``stitch``
    replaces ``repro_torch.stitch`` (the tests' faults)."""
    parts = {"imports_s": time.perf_counter() - t0}
    t = time.perf_counter()
    distinct = cell.traffic["distinct_inputs"]
    inputs = cell.program.make_inputs(cell.config, cell.batch, cell.seq, seed, distinct, device)
    layers, tables, xs = inputs
    _sync(device)
    parts["inputs_s"] = time.perf_counter() - t

    t = time.perf_counter()
    sf = compile_layer(cell, device, stitch)
    parts["port_import_s"] = time.perf_counter() - t
    t = time.perf_counter()
    sf(xs[0], *layers[0].values(), *tables)
    _sync(device)
    first = time.perf_counter() - t
    check_replay(sf, device)
    stats = sf.stats
    parts.update(capture_s=sf.capture_s, lower_s=sf.lower_s,
                 compile_module_s=stats.compile_time_s, build_s=stats.build_time_s,
                 first_call_rest_s=first - sf.capture_s - sf.lower_s - stats.compile_time_s)
    plan = {"generated_kernels": stats.stitched_kernels + stats.standalone_kernels,
            "library_calls": stats.library_calls, "replay_mode": stats.replay_mode,
            "eager_dispatches": stats.eager_dispatches_per_call,
            "replayed_dispatches": stats.traced_dispatches_per_call}
    run = Run(cell=cell, work=cell.program.WORK(cell.config, cell.batch, cell.seq),
              layers=len(layers))
    run.compile_s = first - stats.build_time_s

    # the shape every request uses is built and captured: one replay warms it
    t = time.perf_counter()
    sf(xs[-1], *layers[-1].values(), *tables)
    _sync(device)
    parts["warm_up_s"] = time.perf_counter() - t
    # the compile leaves a large heap: one full collection now, and its
    # objects kept out of later ones, as a long-lived server does, so that
    # a full collection of the compile's heap does not fall in the window
    t = time.perf_counter()
    gc.collect()
    gc.freeze()
    parts["gc_s"] = time.perf_counter() - t
    run.setup_s = time.perf_counter() - t0

    order = traffic_order(seed, distinct)
    samples = Reservoir(SAMPLES, seed)

    def call():
        i = order[run.calls % distinct]
        t = time.perf_counter()
        y = request(sf, inputs, i)
        run.enqueue_ms.append((time.perf_counter() - t) * 1e3)
        _sync(device)
        run.request_ms.append((time.perf_counter() - t) * 1e3)
        samples.offer((i, y))
        run.calls += 1

    device_info = {"platform": "gpu", "kind": _device_name(device), "count": cell.chips}
    if not traced:
        t = time.perf_counter()
        while run.calls == 0 or time.perf_counter() - t < seconds:
            call()
        run.window_s = time.perf_counter() - t
        metric_specs = cell.metrics
    else:
        call()
        per_call_s = max(run.request_ms[-1] / 1e3, 1e-6)
        n = int(min(max(math.ceil(min(seconds, TRACE_SECONDS) / per_call_s), TRACE_CALLS[0]),
                    TRACE_CALLS[1]))
        run.calls, run.request_ms, run.enqueue_ms = 0, [], []
        if device.type == "cuda":
            events, span, host, refused = trace.profiled(call, n)
            if refused:
                print(f"profile retaken, sessions refused: {refused}", file=sys.stderr)
        else:
            events, span, host = _host_profile(call, n)
        # ``profiled`` calls once before the first mark and once after the
        # second: only the requests between the marks are the traced window
        run.calls = n
        run.events = events
        run.device_window_s = (span[1] - span[0]) / 1e6
        run.busy_s = trace.busy_us(events, span) / 1e6
        device_info.update(busy_s=run.busy_s, window_s=run.device_window_s)
        metric_specs = cell.per_layer
        gaps = sorted(trace.idle_gaps(events, span), key=lambda g: -g[1])[:LABELLED_GAPS]
        breakdown = {
            "device_ops": trace.top((name, us) for _, name, us in events),
            "idle_gaps": trace.top((trace.host_activity(host, s + us / 2), us) for s, us in gaps),
        }
    metrics = read_metrics(metric_specs, run)
    if device.type == "cuda":
        device_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    else:
        device_info["memory_peak_bytes"] = 0

    kept = samples.kept
    del sf, call
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    read = worst(errors(cell, inputs, xs[i], y) for i, y in kept)
    checks = {k: {"value": read[k], "limit": lim["limit"]} for k, lim in cell.limits.items()}
    result = {"correct": bool(checks) and all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": run.calls, "failed": 0, "metrics": metrics, "device": device_info}
    if traced:
        result["breakdown"] = breakdown
    result["checks"] = checks
    info = {"setup": parts, "plan": plan}
    if len(run.request_ms) > 1:
        q = statistics.quantiles(run.request_ms, n=4)
        info["request_ms"] = {"min": min(run.request_ms), "q1": q[0], "median": q[1],
                              "q3": q[2], "max": max(run.request_ms),
                              "each": run.request_ms, "enqueued": run.enqueue_ms}
    if traced:
        info["ops_per_request"] = _op_table(run.events, run.calls)
    return result, info


def _op_table(events, calls) -> List[list]:
    """[name, launches a request, device µs a request] of every device activity."""
    table = {}
    for _, name, us in events:
        n, t = table.get(name, (0, 0.0))
        table[name] = (n + 1, t + us)
    return [[name, n / calls, t / calls] for name, (n, t) in
            sorted(table.items(), key=lambda kv: -kv[1][1])]


def _host_profile(call, n):
    """The CPU's stand-in for a profiled session (the tests): no device
    events, the requests' host span."""
    t = time.perf_counter() * 1e6
    for _ in range(n):
        call()
    return [], (t, time.perf_counter() * 1e6), []


def _device_name(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is one of ``FORBIDDEN_MODULES``,
    compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN_MODULES})


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"
    return out.stdout.strip()


def main(argv: List[str], t0: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cell = load_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine has {count}",
              file=sys.stderr)
        return 2
    if not (HERE.parent / "src" / "repro_torch").is_dir():
        print("the port (src/repro_torch) is not in this checkout", file=sys.stderr)
        return 2
    if not cell.limits:
        print(f"{cell.name} has no limits file", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result, info = run_cell(cell, a.seed, a.seconds, bool(a.trace), device, t0)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps({**info, "gpu": _power_limit()}), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
