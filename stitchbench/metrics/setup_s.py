"""Host seconds from the start of the run's process to its first timed
request: imports, weights and inputs from the seed, the compile (capture,
lowering, planning, code generation, building or loading the kernels), the
first call with its graph capture, and one warm replay."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
