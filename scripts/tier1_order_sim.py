"""Replay pytest-xdist's `--dist load` scheduling of the tier-1 suite on
measured test durations, to compare orderings of the collection.

Reads the durations from the junit XML of a whole tier-1 run, orders the
collection with `slow_last_order` of each given conftest.py (the repo's
by default; e.g. an older one from `git show REV:conftest.py`), replays
xdist's LoadScheduling (a first chunk of consecutive items a worker, then
refills as each worker's queue runs low) with every duration scaled by
each --scale, and prints the run's end and the passes made before
--limit. A model: it ignores collection, worker start-up and a test's
wait for a fixture that another worker computes (it missed a real run's
end by up to ~180 s either way).

    JAX_PLATFORMS=cpu python scripts/tier1_order_sim.py --junit run.xml \\
        --conftest conftest.py old_conftest.py --scale 1 1.1 1.2
"""

import argparse
import heapq
import importlib.util
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class _Item:
    def __init__(self, nodeid):
        self.nodeid = nodeid


def collect() -> list:
    """The tier-1 collection, in pytest's order."""
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "-q", "-m", "not slow", "--collect-only",
         "-p", "no:cacheprovider", "-p", "no:randomly"],
        cwd=ROOT, capture_output=True, text=True, check=False).stdout
    return [line.strip() for line in out.splitlines() if "::" in line]


def durations(junit: str):
    """{junit key: (seconds, skipped)} of a junit XML."""
    root = ET.parse(junit).getroot()
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    return {f"{c.get('classname')}.{c.get('name')}":
            (float(c.get("time", 0)), c.find("skipped") is not None)
            for c in suite.iter("testcase")}


def junit_key(nodeid: str) -> str:
    module, _, rest = nodeid.partition("::")
    return module[:-3].replace("/", ".") + "." + rest.replace("::", ".")


def ordered(conftest: str, ids: list, workers: int) -> list:
    spec = importlib.util.spec_from_file_location(f"conftest_{abs(hash(conftest))}", conftest)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    index = {n: i for i, n in enumerate(ids)}
    return [index[it.nodeid] for it in mod.slow_last_order([_Item(n) for n in ids], workers)]


def replay(order, secs, skipped, workers: int, limit: float):
    """(end, passes before limit) of xdist's LoadScheduling over `order`."""
    pending = list(order)
    queues = [[] for _ in range(workers)]
    chunk = max(len(pending) // workers // 4, 2)
    for q in queues:
        q += pending[:chunk]
        del pending[:chunk]
    events = [(secs[q[0]], w) for w, q in enumerate(queues) if q]
    heapq.heapify(events)
    end, passed = 0.0, 0
    while events:
        t, w = heapq.heappop(events)
        end = max(end, t)
        q = queues[w]
        i = q.pop(0)
        passed += t <= limit and not skipped[i]
        if pending:
            low = max(2, len(pending) // workers // 4)
            high = max(2, len(pending) // workers // 2)
            if len(q) < low and not (secs[i] >= 0.1 and len(q) >= 2):
                k = high - len(q)
                q += pending[:k]
                del pending[:k]
        if q:
            heapq.heappush(events, (t + secs[q[0]], w))
    return end, passed


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--junit", required=True, help="junit XML of a whole tier-1 run")
    ap.add_argument("--conftest", nargs="+", default=[str(ROOT / "conftest.py")])
    ap.add_argument("--scale", nargs="+", type=float, default=[1.0])
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--limit", type=float, default=1470.0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    ids = collect()
    measured = durations(args.junit)
    missing = [n for n in ids if junit_key(n) not in measured]
    secs = [measured.get(junit_key(n), (0.0, False))[0] for n in ids]
    skipped = [measured.get(junit_key(n), (0.0, False))[1] for n in ids]
    print(f"{len(ids)} tests collected, {len(missing)} without a duration (taken as 0 s), "
          f"{sum(secs):.1f} worker-seconds")
    for path in args.conftest:
        order = ordered(path, ids, args.workers)
        for s in args.scale:
            end, passed = replay(order, [x * s for x in secs], skipped, args.workers, args.limit)
            print(f"{path}: durations x{s}: ends at {end:.1f} s, {passed} passed by {args.limit:g} s")


if __name__ == "__main__":
    main()
