"""Host entry: from a request's start until the entry returns, before the
host reads the result (from_dataset, the solver's Python and the ctypes
wrapper), mean over the window's requests, in ms (host clock)."""


def read(run):
    s = run.spans.get("host_entry")
    return 1e3 * sum(s) / len(s) if s else None
