"""The Mamba-2 layers' work outside their library products (the
convolution, the gates, the chunked SSD, the gated norm and the MLP's
glue: ``programs/hybrid_layer.py`` ``mamba_seconds_at_roofline``, at the
H100's roofline for the configuration's type), over the device time of
the generated kernels that the Mamba-2 layer's plan built, as a
percentage.

The plan is the ``compile`` span (``repro_torch.tracing``) whose call had
the Mamba-2 layer's arguments; its ``kernels`` attribute names the plan's
kernels.  A kernel that the attention layer's plan launches too (the same
text, so the same work a launch) counts in the share of its launches that
the Mamba-2 layers make.  None in a checkout whose tracer records no
``kernels``."""
from stitchbench import spans


def _plan_kernels(snap, arguments: int):
    """{kernel name: launches a call} of each plan compiled for calls with
    ``arguments`` arguments, and of every other plan, by ``stitch_<hash>``."""
    mine, others = {}, {}
    for s in snap.spans:
        if s.name != "compile" or "kernels" not in s.attrs:
            continue
        into = mine if s.attrs.get("arguments") == arguments else others
        for symbol in s.attrs["kernels"]:
            name = "_".join(symbol.split("_")[:2])
            into[name] = into.get(name, 0) + 1
    return mine, others


def read(run):
    program = run.cell.program
    if not run.events or not run.calls or not hasattr(program, "mamba_seconds_at_roofline"):
        return None
    snap = spans.snapshot()
    if snap is None:
        return None
    mine, others = _plan_kernels(snap, 1 + len(program.MAMBA_WEIGHTS) + 2)
    if not mine:
        return None
    types = program.held_types(run.cell.config)
    n_mamba, n_other = types.count("mamba"), len(types) - types.count("mamba")
    us = 0.0
    for name, launches in mine.items():
        share = n_mamba * launches / (n_mamba * launches + n_other * others.get(name, 0))
        us += share * sum(d for _, n, d in run.events if name in n)
    if us <= 0:
        return None
    cell = run.cell
    need = n_mamba * program.mamba_seconds_at_roofline(cell.config, cell.batch, cell.seq)
    return 100.0 * need * run.calls / (us / 1e6)
