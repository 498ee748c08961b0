"""Host seconds of the first call of the stitched function (capture, lower,
the pass pipeline, code generation, loading the kernels, the first
execution and graph capture), less the seconds nvcc spent in it: the
compile with the build cache warm."""


def read(run):
    return run.compile_s if run.compile_s > 0 else None
