"""Host seconds of building the generated kernels with nvcc, or finding
them built, and loading them: the port's ``build`` spans
(``repro_torch.tracing``)."""
from stitchbench import spans


def read(run):
    return spans.named("build")
