"""Schur elimination (solver/schur.py::block_eliminate: the blocks' batched
Cholesky and triangular solves): device ms an iteration between the
iteration's "assemble" and "block_cholesky" marks (CUDA events), mean."""


def read(run):
    s = run.stages.get("block_cholesky")
    return sum(s) / len(s) if s else None
