"""Schur separator (solver/schur.py::separator_products and
separator_solve: the two GEMMs, then the separator's Cholesky): device ms
an iteration of the "separator_products" and "separator_cholesky" stages
(CUDA events at the marks), mean."""


def read(run):
    a, b = run.stages.get("separator_products"), run.stages.get("separator_cholesky")
    return sum(a) / len(a) + sum(b) / len(b) if a and b else None
