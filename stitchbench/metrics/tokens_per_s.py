"""Tokens of every request completed in the window (each through every
layer), over the window's host seconds."""


def read(run):
    return run.calls * run.work.tokens / run.window_s if run.window_s > 0 else None
