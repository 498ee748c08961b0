"""Host seconds the port spent capturing the layer with ``make_fx``: its
``capture`` spans (``repro_torch.tracing``)."""
from stitchbench import spans


def read(run):
    return spans.named("capture")
