"""The library products' operations and bytes at the H100's roofline for
the configuration's type, over the device time of the library's GEMM
kernels, as a percentage."""
from stitchbench import trace, work


def read(run):
    if not run.events or not run.calls:
        return None
    us = sum(d for _, n, d in run.events if trace.is_gemm(n))
    if us <= 0:
        return None
    need = work.seconds_at_roofline(run.work.gemm_flops, run.work.gemm_bytes,
                                    run.work.peak_flops)
    return 100.0 * need * run.calls / (us / 1e6)
