"""``python -m repro_torch.lint`` — compile-and-verify lint of the port.

Compiles the ten paper graphs of ``repro_torch.graphs`` (or a named subset)
under ``verify="strict"`` in both planner modes and prints one row per
compile.  Any verifier diagnostic (a broken IR invariant, an illegal
fusion, an unsound schedule, a kernel past its shared memory, a slot race
in the ExecutionPlan or its CUDA graph) fails the run with exit status 1
and the diagnostics on stderr.

Usage::

    python -m repro_torch.lint                       # all graphs, both planners, on the card
    python -m repro_torch.lint --device cpu          # the plain kernels, no card
    python -m repro_torch.lint --graphs LR,NMT --planner greedy

On the card every compile also builds its kernels with nvcc.
"""
from __future__ import annotations

import argparse
import sys
from typing import List

from repro_torch.core import StitchOptions, VerificationError, compile_module
from repro_torch.graphs import ALL_GRAPHS


def lint_graph(name: str, module, planner: str, max_blocks: int, device) -> List[str]:
    """Compile one graph under strict verification; return failure lines."""
    opts = StitchOptions(max_blocks=max_blocks, planner=planner, verify="strict")
    try:
        cm = compile_module(module, opts, device=device)
    except VerificationError as e:
        return [f"{name} [{planner}] {d}" for d in e.diagnostics]
    except Exception as e:  # noqa: BLE001 — a lint driver reports, never hides
        return [f"{name} [{planner}] compile failed: {type(e).__name__}: {e}"]
    s = cm.stats
    print(
        f"  {name:<14} {planner:<7} "
        f"kernels={s.stitched_kernels + s.standalone_kernels:<3} "
        f"boundaries={s.verify_boundaries} warnings={s.verify_warnings} "
        f"verify={s.verify_time_s * 1e3:.1f}ms"
    )
    return []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.lint",
                                 description="strict-verify compile lint over the paper graphs")
    ap.add_argument("--graphs", default="", help="comma-separated graph names (default: all)")
    ap.add_argument("--planner", default="both", choices=("cost", "greedy", "both"),
                    help="planner mode(s) to lint under")
    ap.add_argument("--max-blocks", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the compiles run (default: the card)")
    args = ap.parse_args(argv)

    names = [n.strip() for n in args.graphs.split(",") if n.strip()] or list(ALL_GRAPHS)
    unknown = [n for n in names if n not in ALL_GRAPHS]
    if unknown:
        ap.error(f"unknown graph(s) {unknown}; choices: {sorted(ALL_GRAPHS)}")
    planners = ("cost", "greedy") if args.planner == "both" else (args.planner,)

    print(f"repro_torch.lint: {len(names)} graph(s) x {len(planners)} planner mode(s) "
          f"on {args.device}")
    failures: List[str] = []
    for name in names:
        for planner in planners:
            failures.extend(lint_graph(name, ALL_GRAPHS[name](), planner, args.max_blocks,
                                       args.device))
    if failures:
        print(f"\n{len(failures)} diagnostic(s):", file=sys.stderr)
        for line in failures:
            print(f"  {line}", file=sys.stderr)
        return 1
    print("clean: zero diagnostics")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
