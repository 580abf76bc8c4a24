"""Replay a pytest junit XML's test times on N xdist workers in
``--dist loadfile`` order, to see when a whole run would end.

pytest-xdist's ``loadfile`` scheduler (``xdist/scheduler/loadscope.py``)
queues the test files by test count, largest first; each worker takes
one file, then a second at once, and another whenever two or fewer of
its assigned tests are pending.  A worker runs its tests in order.  This
replays that schedule on the junit's per-test seconds (start-up and
collection not included) and prints the replay's end and the files that
end last.

    python scripts/junit_replay.py JUNIT.xml [--workers 6] [--tail 8]
"""
import argparse
import collections
import heapq
import xml.etree.ElementTree as ET


def file_of(classname: str) -> str:
    """``tests.test_x`` or ``tests.test_x.TestClass`` -> ``tests/test_x.py``."""
    parts = classname.split(".")
    while parts and not parts[-1].startswith("test_"):
        parts.pop()
    return "/".join(parts) + ".py"


def load(path: str):
    files = collections.OrderedDict()
    for tc in ET.parse(path).iter("testcase"):
        files.setdefault(file_of(tc.get("classname", "")), []).append(
            float(tc.get("time", 0.0)))
    return files


def replay(files, workers: int):
    """(end seconds, {file: (start, end, worker)})."""
    queue = collections.deque(sorted(files, key=lambda f: -len(files[f])))
    pending = [collections.deque() for _ in range(workers)]
    span = {}

    def assign(w, now):
        f = queue.popleft()
        for t in files[f]:
            pending[w].append((f, t))
        span[f] = [None, None, w]

    for w in range(workers):
        if queue:
            assign(w, 0.0)
    for w in range(workers):
        if queue and len(pending[w]) <= 2:
            assign(w, 0.0)
    clock = [(0.0, w) for w in range(workers)]
    heapq.heapify(clock)
    end = 0.0
    while clock:
        now, w = heapq.heappop(clock)
        if not pending[w]:
            end = max(end, now)
            continue
        f, t = pending[w].popleft()
        if span[f][0] is None:
            span[f][0] = now
        span[f][1] = now + t
        if queue and len(pending[w]) <= 2:
            assign(w, now + t)
        heapq.heappush(clock, (now + t, w))
    return end, span


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("junit")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--tail", type=int, default=8)
    args = ap.parse_args()
    files = load(args.junit)
    end, span = replay(files, args.workers)
    print(f"replay end: {end:.1f} s on {args.workers} workers "
          f"({sum(len(v) for v in files.values())} tests, {len(files)} files)")
    for f, (a, b, w) in sorted(span.items(), key=lambda x: -x[1][1])[
            :args.tail]:
        print(f"  {f}: {len(files[f])} tests, {sum(files[f]):.1f} s, "
              f"gw{w} {a:.1f} -> {b:.1f}")


if __name__ == "__main__":
    main()
