"""Solves completed in the window over the window's length (host clock)."""


def read(run):
    return len(run.latencies) / run.window_s
