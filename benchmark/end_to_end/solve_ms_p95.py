"""The 95th percentile of the window's request times, from a request's start
to its poses on the host, in ms (numpy's linear interpolation)."""

import numpy as np


def read(run):
    return 1e3 * float(np.percentile(run.latencies, 95))
