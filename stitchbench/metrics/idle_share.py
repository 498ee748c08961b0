"""The share of the profiled window, between its two marks on the device's
clock, in which no device activity ran, as a percentage."""


def read(run):
    if not run.events or run.device_window_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.device_window_s)
