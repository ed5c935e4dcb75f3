"""Rank preparation (parallel/dist_schur.py::prepare_rank: the host's
integer indices of a topology, moved to the card), host clock around the
call, mean a request, in ms."""


def read(run):
    s = run.spans.get("schur_prepare")
    return 1e3 * sum(s) / len(s) if s else None
