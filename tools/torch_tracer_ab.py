"""The tracer's cost on the card, from two checkouts in alternation: the
in-process profiler's milliseconds per batch and `cli benchmark` with
the server traced and `--untraced`, so that a shift between two trees
(for example the tracer's recording core before and after a change) can
be told from the run-to-run spread.

    python3 tools/torch_tracer_ab.py A_ROOT B_ROOT [--pairs 1] [--batches 24]

A_ROOT and B_ROOT are checkouts of the repo (for example a parent commit
and a change unpacked with `git archive`). Runs go A B B A A B ..., each
run three processes started from that checkout's root: one builds its
kernels and drives `profile_e2e.run` (PRODUCTION, default stages, 8
warm-up and `--batches` measured batches of 8190 transfers; the tracer
is on, as profile_e2e always runs it); then `cli benchmark --accounts
10000 --transfers 163800 --queries 10` with the server traced (its
/metrics port on) and with `--untraced`. A line of JSON per measurement
and a summary per tree go to standard output; the first line is the
card's name and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

CHILD = r"""
import json, sys
sys.path.insert(0, ".")
from tigerbeetle_tpu_torch import profile_e2e
from tigerbeetle_tpu_torch.ops import kernels

kernels.build_all()
rec = profile_e2e.run(device="cuda", batches=int(sys.argv[1]), out=lambda s: None)
print(json.dumps({"run": "profile", "ms_per_batch": rec["value"],
                  "tx_per_s": rec["tx_per_s"]}))
"""

BENCH_KEYS = ("load_accepted_tx_per_s", "batch_p50_ms", "batch_p99_ms")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def one_tree(root: str, batches: int) -> list:
    out = subprocess.run([sys.executable, "-c", CHILD, str(batches)], cwd=root,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise SystemExit(f"profile_e2e in {root} failed:\n{out.stdout[-4000:]}{out.stderr[-4000:]}")
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    for label, extra in (("bench traced", ["--metrics-port", str(free_port())]),
                         ("bench untraced", ["--untraced"])):
        out = subprocess.run(
            [sys.executable, "-m", "tigerbeetle_tpu_torch.cli", "benchmark",
             "--accounts", "10000", "--transfers", "163800", "--queries", "10",
             "--port", str(free_port()), "--device", "cuda", "--config", "production",
             *extra],
            cwd=root, capture_output=True, text=True, timeout=900, start_new_session=True)
        line = next((x for x in out.stdout.splitlines() if x.startswith("BENCH_JSON ")), None)
        if out.returncode or line is None:
            raise SystemExit(f"{label} in {root} failed:\n{out.stdout[-4000:]}{out.stderr[-4000:]}")
        res = json.loads(line[len("BENCH_JSON "):])
        rows.append({"run": label, **{k: res[k] for k in BENCH_KEYS}})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs=2)
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--batches", type=int, default=24)
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    order = []
    for i in range(args.pairs):
        order += [0, 1, 1, 0]
    runs = {0: [], 1: []}
    for k in order:
        for row in one_tree(os.path.abspath(args.roots[k]), args.batches):
            row["tree"] = "AB"[k]
            runs[k].append(row)
            print(json.dumps(row), flush=True)
    for k, rows in runs.items():
        for run in dict.fromkeys(r["run"] for r in rows):
            mine = [r for r in rows if r["run"] == run]
            print(json.dumps({"tree": "AB"[k], "root": args.roots[k], "run": run, **{
                key: [r[key] for r in mine] for key in mine[0] if key not in ("run", "tree")}}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
