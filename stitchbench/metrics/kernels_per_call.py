"""Device activities (generated kernels, library kernels, copies and fills)
between the profiled session's marks, over the stitched calls between them
(a call a layer of each request)."""


def read(run):
    return len(run.events) / (run.calls * run.layers) if run.events and run.calls else None
