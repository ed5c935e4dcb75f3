"""The CPU emulation's shared headers under builds started at once.

scripts/emulate_gn_kernel.py builds several CUDA sources into one
directory, one g++ a source, all running together; each source includes the
shared headers written beside it (the emulation's cuda_runtime.h and
cooperative_groups.h, the rewritten csrc/*.cuh). GCC's `#pragma once` tells
files apart partly by their modification time, so a header rewritten while
a g++ reads it is taken for a new file, and its definitions come twice.
`write_headers` writes each file through a temporary file and os.replace,
and only where its text changed. Here several writers run at once into one
directory while readers read the files: every read must be a whole text (the
intended one, or the stale one it replaces), the files end with the intended
texts, and a write of unchanged texts leaves each file's inode and mtime
alone. No g++ is needed.
"""
import importlib.util
import os
import threading
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
WRITERS, READERS, ROUNDS = 6, 3, 10


@pytest.fixture(scope="module")
def emu():
    spec = importlib.util.spec_from_file_location(
        "emulate_gn_kernel_under_test", ROOT / "scripts" / "emulate_gn_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stamp(path: Path):
    st = path.stat()
    return st.st_ino, st.st_mtime_ns


@pytest.mark.parametrize("start", ["empty", "stale", "unchanged"])
def test_concurrent_header_writes_never_show_a_partial_file(emu, tmp_path, start):
    texts = emu.header_texts(ROOT)
    assert {"cuda_runtime.h", "cooperative_groups.h", "persistent.cuh"} <= set(texts)
    if start == "stale":  # an older checkout's headers, each to be replaced
        for name, text in texts.items():
            (tmp_path / name).write_text(text + "\n// stale\n")
    elif start == "unchanged":
        emu.write_headers(tmp_path, ROOT)
    before = {name: _stamp(tmp_path / name) for name in texts} if start == "unchanged" else {}
    allowed = {name: {text, text + "\n// stale\n"} for name, text in texts.items()}
    bad, reads = [], [0]
    done = threading.Event()
    barrier = threading.Barrier(WRITERS + READERS)

    def writer():
        barrier.wait()
        for _ in range(ROUNDS):
            emu.write_headers(tmp_path, ROOT)

    def reader():
        barrier.wait()
        while not done.is_set():
            for name in texts:
                try:
                    got = (tmp_path / name).read_text()
                except FileNotFoundError:
                    if start != "empty":
                        bad.append((name, "missing"))
                    continue
                reads[0] += 1
                if got not in allowed[name]:
                    bad.append((name, len(got)))

    readers = [threading.Thread(target=reader) for _ in range(READERS)]
    writers = [threading.Thread(target=writer) for _ in range(WRITERS)]
    for t in readers + writers:
        t.start()
    for t in writers:
        t.join()
    done.set()
    for t in readers:
        t.join()
    assert not bad, bad[:10]
    assert reads[0] > 0
    for name, text in texts.items():
        assert (tmp_path / name).read_text() == text, name
    # no temporary file is left behind
    assert sorted(os.listdir(tmp_path)) == sorted(texts)
    if start == "unchanged":
        assert {name: _stamp(tmp_path / name) for name in texts} == before
    # a second write of unchanged texts touches nothing
    stamps = {name: _stamp(tmp_path / name) for name in texts}
    emu.write_headers(tmp_path, ROOT)
    assert {name: _stamp(tmp_path / name) for name in texts} == stamps
