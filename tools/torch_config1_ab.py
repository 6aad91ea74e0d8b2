"""BASELINE config 1 on the PyTorch port (chip_smoke.py's phase 3) alone,
or the mesh (its phase 9), from two checkouts in alternation on one card:
batch latencies and span totals of each run, so that a shift between two
trees can be told from the run-to-run spread.

    python3 tools/torch_config1_ab.py A_ROOT B_ROOT [--pairs 4] [--seed S]
        [--phase config1|mesh|commit]

A_ROOT and B_ROOT are checkouts of the repo (for example a parent commit
and a change unpacked with `git archive`). Runs go A B B A A B B A ...,
each in a process of its own that imports that checkout's
`tigerbeetle_tpu_torch` and `chip_smoke.py`, builds its kernels, then
drives config 1 (10,000 accounts, 64 uniform batches of 8190 transfers
on CUDA against a CPU twin) `--reps` times from the same seed; with
`--phase mesh` it drives phase 9 once instead (config 2's and config 3's
traffic on `make_mesh([cuda:0] * 8)` and on one device, chip_smoke.py's
seed for it): transfers/s, p50 and p99 of each of the four machine runs
and the mean of each of the mesh's device windows. A line of JSON per
run and a summary per tree go to standard output. With `--phase commit`
it times the mesh's two host-orchestrated calls alone, warm, on phase 9's
mesh (2^20 accounts, chip_smoke.py's post batch of 8192 events, 16,384
slots): `sharded_commit` (the fast commit) and `read_balances_sharded`
(the serial route's and the lookups' read), 30 calls each to warm up,
then 200, each from the call to its return (`*_enqueue_ms`) and to the
device's finish after it (`*_ms`): medians a run. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SPAN_PREFIXES = ("sm.", "lsm.", "qindex.", "device.step.")


def mesh_child(cs, torch, np, root: str, seed: int) -> None:
    """Phase 9 once: a JSON line per machine run, from chip_smoke.py's log."""
    from tigerbeetle_tpu_torch.parallel import sharding

    lines = []
    cs.log = lambda *a: lines.append(" ".join(map(str, a)))
    cs.CARD[0] = cs.gpu_name_power()
    mesh = sharding.make_mesh([torch.device("cuda", 0)] * cs.MESH_DEVICES)
    cs.phase_mesh(torch, np.random.default_rng(seed + 19), cs.zipf_of(1_000_000), mesh)
    windows = {}
    for line in lines:
        if " mesh: device windows " in line:
            name, _, rest = line.partition(" mesh: device windows ")
            windows[name] = {k: v["mean_ms"] for k, v in
                             json.loads(rest.partition("; launches ")[0]).items()}
    for line in lines:
        if "transfers_per_s=" not in line:
            continue
        head, _, rest = line.partition(": ")
        name, label = head.split(" (")[0].rsplit(" ", 1)
        vals = dict(kv.split("=", 1) for kv in rest.split(" stats=")[0].split())
        print(json.dumps({
            "root": root, "run": f"{name} {label}",
            "transfers_per_s": float(vals["transfers_per_s"]),
            "p50_ms": float(vals["batch_p50_ms"]), "p99_ms": float(vals["batch_p99_ms"]),
            "windows_mean_ms": windows.get(name, {}) if label == "mesh" else {},
        }), flush=True)


def commit_child(cs, torch, np, root: str, seed: int) -> None:
    """The mesh's fast commit and sharded read, warm: one JSON line."""
    import time

    from tigerbeetle_tpu_torch.ops import commit as C
    from tigerbeetle_tpu_torch.parallel import sharding as S

    dev = torch.device("cuda", 0)
    mesh = S.make_mesh([dev] * cs.MESH_DEVICES)
    rng = np.random.default_rng(seed)
    state = S.sharded_state_from_reference(cs.kernel_state(rng, C), mesh)
    b_np, host_np = cs.kernel_batch(rng, C, False)
    b = C.TransferBatch(**{k: torch.from_numpy(v).to(dev) for k, v in b_np.items()})
    host = torch.from_numpy(host_np).to(dev)
    slots = torch.from_numpy(rng.integers(0, cs.A_MAX, 2 * cs.N).astype(np.int32)).to(dev)
    calls = {"fast_commit": lambda: S.sharded_commit(mesh, cs.A_MAX, state, b, host),
             "read": lambda: S.read_balances_sharded(mesh, cs.A_MAX, state, slots)}
    row = {"root": root, "run": "commit"}
    for name, call in calls.items():
        enqueue, wall = [], []
        for i in range(230):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            del out
            if i >= 30:
                enqueue.append(t1 - t0)
                wall.append(t2 - t0)
        row[f"{name}_enqueue_ms"] = float(np.median(enqueue) * 1e3)
        row[f"{name}_ms"] = float(np.median(wall) * 1e3)
    row["p50_ms"] = row["fast_commit_ms"]
    print(json.dumps(row), flush=True)


def child(root: str, seed: int, reps: int, phase: str) -> None:
    root = os.path.abspath(root)
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import numpy as np
    import torch

    import chip_smoke as cs
    from tigerbeetle_tpu_torch import native, tracer
    from tigerbeetle_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    kernels.build_all()
    native.hostops()
    if phase == "mesh":
        return mesh_child(cs, torch, np, root, seed)
    if phase == "commit":
        return commit_child(cs, torch, np, root, seed)
    lines = []
    cs.log = lambda *a: lines.append(" ".join(map(str, a)))
    n1 = 10_000
    t1 = n1 - 2
    uniform = lambda r, n: cs.distinct_pair(r.integers(0, t1, n), r.integers(0, t1, n), t1)
    for rep in range(reps):
        lines.clear()
        cs.run_config(torch, "config1", n1, 64, uniform, np.random.default_rng(seed),
                      np.arange(1, n1 + 1), 2)
        snap = tracer.snapshot()
        tag = "config1: batch latencies ms "
        lat = json.loads(next(l for l in lines if l.startswith(tag))[len(tag):])
        ms = np.array(lat[1:])  # the first batch pays one-time setup
        print(json.dumps({
            "root": root, "run": "config1", "rep": rep, "batches": len(ms),
            "p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
            "mean_ms": float(ms.mean()),
            "spans_ms": {k: round(v["total_ms"], 3) for k, v in sorted(snap.items())
                         if k.startswith(SPAN_PREFIXES) and v["total_ms"] > 0},
        }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=20261017)
    ap.add_argument("--phase", choices=("config1", "mesh", "commit"), default="config1")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.seed, args.reps, args.phase)
        return 0
    if len(args.roots) != 2:
        ap.error("give two checkouts, A_ROOT and B_ROOT")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    order = []
    for i in range(args.pairs):
        order += [0, 1] if i % 2 == 0 else [1, 0]
    runs = {0: [], 1: []}
    for k in order:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", args.roots[k],
             "--seed", str(args.seed), "--reps", str(args.reps), "--phase", args.phase],
            capture_output=True, text=True, timeout=900,
        )
        if out.returncode != 0:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            return 1
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                row = json.loads(line)
                row["tree"] = "AB"[k]
                runs[k].append(row)
                print(json.dumps(row), flush=True)
    for k, all_rows in runs.items():
        for run in dict.fromkeys(r["run"] for r in all_rows):
            rows = [r for r in all_rows if r["run"] == run]
            summary = {"tree": "AB"[k], "root": args.roots[k], "run": run, "runs": len(rows),
                       "p50_ms": sorted(r["p50_ms"] for r in rows)}
            if run == "commit":
                for key in rows[0]:
                    if key.endswith("_ms"):
                        summary[key] = sorted(r[key] for r in rows)
            elif run == "config1":
                spans = sorted({s for r in rows for s in r["spans_ms"]})
                summary["mean_ms"] = sorted(r["mean_ms"] for r in rows)
                summary["spans_ms_min_max"] = {
                    s: [min(r["spans_ms"].get(s, 0.0) for r in rows),
                        max(r["spans_ms"].get(s, 0.0) for r in rows)] for s in spans}
            else:
                summary["transfers_per_s"] = sorted(r["transfers_per_s"] for r in rows)
                windows = sorted({w for r in rows for w in r["windows_mean_ms"]})
                summary["windows_mean_ms"] = {
                    w: sorted(r["windows_mean_ms"][w] for r in rows) for w in windows}
            print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
