"""The port's tracer on the host: microseconds per recorded iteration
(one span around a little Python work, one counter bump) with one
thread and with several threads recording at once, for one or more
checkouts, each run in a process of its own.

    python tools/torch_tracer_contention.py A_ROOT [B_ROOT ...] [--rounds 2]
        [--threads 4] [--iters 100000]

Roots run A B B A ... `--rounds` times. A tracer that serialises its
records on one lock pays for it most when several threads record: a
thread that holds the lock and loses the interpreter lock stalls every
other recording thread. Runs on the CPU; prints one JSON line a run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys, threading, time
sys.path.insert(0, ".")
from tigerbeetle_tpu_torch import tracer

n_iter, n_threads = int(sys.argv[1]), int(sys.argv[2])


def work():
    x = 0
    for _ in range(n_iter):
        with tracer.span("contention.span"):
            for j in range(20):
                x += j
        tracer.count("contention.count")


tracer.enable()
out = {}
for nt in (1, n_threads):
    tracer.reset()
    threads = [threading.Thread(target=work) for _ in range(nt)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out[f"us_per_iter_{nt}_threads"] = round(
        (time.perf_counter() - t0) / (nt * n_iter) * 1e6, 3)
    assert tracer.snapshot()["contention.count"]["count"] == nt * n_iter
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--iters", type=int, default=100_000)
    args = ap.parse_args()
    order = []
    for i in range(args.rounds):
        order += list(range(len(args.roots)))[:: 1 if i % 2 == 0 else -1]
    for k in order:
        out = subprocess.run(
            [sys.executable, "-c", CHILD, str(args.iters), str(args.threads)],
            cwd=os.path.abspath(args.roots[k]), capture_output=True, text=True,
            timeout=600, check=True)
        print(json.dumps({"root": args.roots[k], **json.loads(out.stdout.splitlines()[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
