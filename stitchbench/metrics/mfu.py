"""Every operation a request needs (``work.Work.flops``), over the profiled
window's time a request on the device's clock times the H100's peak for the
configuration's type, as a percentage."""


def read(run):
    if not run.events or run.device_window_s <= 0 or not run.calls:
        return None
    per_call_s = run.device_window_s / run.calls
    return 100.0 * run.work.flops / (per_call_s * run.work.peak_flops)
