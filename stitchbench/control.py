"""The readings a cell's limits are set from, on the card, in one process:

    python3 stitchbench/control.py --workload <name> --seeds <n> [<n> ...]

For each seed, the program's ``errors`` and the control's
(``harness.control_readings``: the reference in the precision below the
configuration's, put in the program's place).  Prints one JSON line a seed
and a summary line.  The benchmark's runs do not run this.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]


def main(argv):
    import argparse
    import json

    import torch

    from stitchbench import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    cell = harness.load_cell(a.workload)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    program, control = [], []
    t = time.perf_counter()
    for seed, prog, ctl in harness.control_readings(cell, a.seeds, torch.device("cuda", 0)):
        program.append(prog)
        control.append(ctl)
        print(json.dumps({"seed": seed, "program": prog, "control": ctl,
                          "s": time.perf_counter() - t}), flush=True)
        t = time.perf_counter()
    print(json.dumps({"workload": cell.name, "precision": harness.CONTROL[cell.shape["dtype"]],
                      "program_max": harness.worst(program),
                      "control_min": {k: min(c[k] for c in control) for k in control[0]},
                      "program": program, "control": control}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
