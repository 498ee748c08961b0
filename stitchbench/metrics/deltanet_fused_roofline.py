"""The Gated DeltaNet layers' work outside their library products (the
short convolutions, the gates, the L2 norms, the chunked delta rule with
its forward substitution and its loop over the chunks, the gated norm and
the MLP's glue: ``programs/gated_deltanet_layer.py``
``deltanet_seconds_at_roofline``, at the H100's roofline for the
configuration's type), over the device time of the generated kernels that
the Gated DeltaNet layer's plan built, as a percentage.

The plan is the ``compile`` span (``repro_torch.tracing``) whose call had
the Gated DeltaNet layer's arguments; its ``kernels`` attribute names the
plan's kernels, its loop body's among them.  A kernel that the
full-attention layer's plan launches too counts in the share of its
launches that the Gated DeltaNet layers make, as in
``mamba_fused_roofline``.  None in a checkout whose tracer records no
``kernels``."""
from stitchbench import spans
from stitchbench.metrics.mamba_fused_roofline import _plan_kernels

KIND = "linear_attention"


def attributed(run):
    """(Gated DeltaNet layers a request, [(launches, µs) of each event of
    the plan's kernels, weighted by the Gated DeltaNet layers' share of the
    kernel's launches]), or None where the run has nothing to attribute."""
    program = run.cell.program
    if not run.events or not run.calls or not hasattr(program, "deltanet_seconds_at_roofline"):
        return None
    snap = spans.snapshot()
    if snap is None:
        return None
    mine, others = _plan_kernels(snap, 1 + len(program.LINEAR_WEIGHTS) + 2)
    if not mine:
        return None
    types = program.held_types(run.cell.config)
    n_lin, n_other = types.count(KIND), len(types) - types.count(KIND)
    out = []
    for name, launches in mine.items():
        share = n_lin * launches / (n_lin * launches + n_other * others.get(name, 0))
        out += [(share, share * d) for _, n, d in run.events if name in n]
    return n_lin, out


def read(run):
    got = attributed(run)
    if got is None:
        return None
    n_lin, events = got
    us = sum(d for _, d in events)
    if us <= 0:
        return None
    cell = run.cell
    need = n_lin * cell.program.deltanet_seconds_at_roofline(cell.config, cell.batch, cell.seq)
    return 100.0 * need * run.calls / (us / 1e6)
