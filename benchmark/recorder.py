"""Host spans and device stage times of the requests in a window.

`span(name)` times a block on the host's clock (and, in a traced run,
names it in the profiler's timeline as "bench.<name>"); `mark(stage)` is
the program's stage hook (`gn_iteration(mark=)`): on the card it records a
CUDA event, and once the request has synchronised `settle()` turns the
marks into the time of each stage (from the mark before it), per
iteration. `begin_iteration()` starts an iteration's marks.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Recorder:
    def __init__(self, device: torch.device, trace: bool):
        self.cuda = device.type == "cuda"
        self.trace = trace
        self.spans = defaultdict(list)   # name -> seconds, one a request
        self.stages = defaultdict(list)  # stage -> ms, one an iteration
        self._marks = []

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = torch.profiler.record_function(f"bench.{name}") if self.trace else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
        self.spans[name].append(time.perf_counter() - t0)

    def _stamp(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def begin_iteration(self):
        self._marks.append([("start", self._stamp())])

    def mark(self, stage: str):
        self._marks[-1].append((stage, self._stamp()))

    def settle(self):
        """The marks of the request's iterations as stage times; call after
        the request's result has reached the host."""
        for marks in self._marks:
            for (_, a), (stage, b) in zip(marks, marks[1:]):
                ms = a.elapsed_time(b) if self.cuda else 1e3 * (b - a)
                self.stages[stage].append(ms)
        self._marks = []
