"""The generated kernels a Gated DeltaNet layer call launches on the
device: the launches of the kernels that the Gated DeltaNet layer's plan
names (its ``compile`` span's ``kernels``, the loop body's among them; a
kernel the full-attention layer's plan launches too counts in the Gated
DeltaNet layers' share of its launches), over the traced Gated DeltaNet
layer calls.  Library products and copies are not counted: their number is
the program's, not the planner's.  None in a checkout whose tracer records
no ``kernels``."""
from stitchbench.metrics.deltanet_fused_roofline import attributed


def read(run):
    got = attributed(run)
    if got is None:
        return None
    n_lin, events = got
    launches = sum(share for share, _ in events)
    return launches / (run.calls * n_lin) if launches > 0 else None
