"""The stack's work outside its library products at the H100's roofline
(``work.seconds_at_roofline`` of its needed operations at the peak of the
configuration's type and its bytes read and written once), over the device
time of every kernel that is neither a library product nor a copy, as a
percentage."""
from stitchbench import trace, work


def read(run):
    if not run.events or not run.calls:
        return None
    us = sum(d for _, n, d in run.events if not trace.is_gemm(n) and not trace.is_copy(n))
    if us <= 0:
        return None
    need = work.seconds_at_roofline(run.work.fused_flops, run.work.fused_bytes,
                                    run.work.peak_flops)
    return 100.0 * need * run.calls / (us / 1e6)
