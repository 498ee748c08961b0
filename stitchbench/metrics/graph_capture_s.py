"""Host seconds of the replay's warm-up and CUDA-graph capture: the port's
``graph_capture`` spans (``repro_torch.tracing``)."""
from stitchbench import spans


def read(run):
    return spans.named("graph_capture")
