"""Device: the share of the traced window in which no kernel, copy or set
ran on the card (1 - the union of the profiler's device records over the
window), in %. None where the profiler kept no device record."""


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
