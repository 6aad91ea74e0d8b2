"""Repeat the port's cluster-plane benchmark and show where its peer
separation comes from.

Each run is one `testing/chaos.run_cluster_plane_bench` (three `cli
start` processes, one backup's link to the primary delayed). Per run it
prints one JSON line: the separation check of
tests/test_torch_cluster_plane.py (the delayed peer's prepare_ok p99
over twice the healthy peer's), both p99s, the section's seconds, and
for each peer its largest prepare_ok on the primary's /trace with that
ack's op index among the peer's acks. With `--spans`, what the healthy
backup and the primary were doing during the healthy peer's first
eight acks and its largest one follows: every span of 1 ms or more
that overlaps the ack (thread, name, start relative to the broadcast,
duration), from both replicas' /trace (one clock: the spans are
perf_counter stamps of one host). A last line sums the runs.

    python tools/torch_cluster_plane_runs.py --runs 8              # the card, bench defaults
    python tools/torch_cluster_plane_runs.py --runs 4 --device cpu \\
        --accounts 500 --batch 128 --batches 12 --delay-ms 40     # the CPU test's sizes
    python tools/torch_cluster_plane_runs.py --runs 8 --spans      # and what held the acks
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tigerbeetle_tpu_torch.testing.chaos import run_cluster_plane_bench  # noqa: E402


def largest_ack(trace: dict, replica: int) -> dict:
    """The longest `vsr.peer.<replica>.prepare_ok` span of a primary's
    /trace document, in ms, with its index among that peer's acks."""
    acks = sorted((e for e in trace["traceEvents"]
                   if e.get("name") == f"vsr.peer.{replica}.prepare_ok"),
                  key=lambda e: e["ts"])
    if not acks:
        return {"acks": 0}
    i = max(range(len(acks)), key=lambda k: acks[k].get("dur", 0))
    return {"acks": len(acks), "op_index": i, "ms": round(acks[i].get("dur", 0) / 1e3, 3)}


def ack_spans(traces: list, primary: int, replica: int, index: int,
              min_ms: float = 1.0) -> list:
    """The spans of `min_ms` or more, on the backup `replica` and on the
    primary, that overlap the primary's `index`-th prepare_ok span of
    that backup: [who, thread, name, start ms after the broadcast, ms]."""
    acks = sorted((e for e in traces[primary]["traceEvents"]
                   if e.get("name") == f"vsr.peer.{replica}.prepare_ok"),
                  key=lambda e: e["ts"])
    a = acks[index]
    t0, t1 = a["ts"], a["ts"] + a.get("dur", 0)
    out = []
    for who, r in (("backup", replica), ("primary", primary)):
        events = traces[r]["traceEvents"]
        threads = {e["tid"]: e["args"]["name"] for e in events if e.get("ph") == "M"}
        for e in events:
            if (e.get("ph") == "X" and e["ts"] < t1 and e["ts"] + e["dur"] > t0
                    and e["dur"] >= min_ms * 1e3 and not e["name"].endswith(".idle")
                    and not e["name"].startswith(("vsr.peer.", "vsr.replication", "vsr.quorum"))):
                out.append([who, threads.get(e["tid"], "?"), e["name"],
                            round((e["ts"] - t0) / 1e3, 2), round(e["dur"] / 1e3, 2)])
    return sorted(out, key=lambda x: x[3])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--accounts", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--delay-ms", type=float, default=30.0)
    ap.add_argument("--spans", action="store_true",
                    help="print what both replicas did during the healthy peer's "
                         "first eight acks and its largest")
    args = ap.parse_args(argv)
    passed = 0
    for k in range(args.runs):
        out = run_cluster_plane_bench(
            accounts=args.accounts, batch=args.batch, batches=args.batches,
            delay_ms=args.delay_ms, device=args.device, collect_traces=True,
        )
        traces = out.pop("_traces")
        out.pop("_statuses")
        primary, delayed = out["primary"], out["delayed_replica"]
        healthy = next(r for r in range(3) if r not in (primary, delayed))
        ok = out["delayed_peer_ok_p99_ms"] > 2 * out["healthy_peer_ok_p99_ms"]
        passed += ok
        print(json.dumps({
            "run": k, "separated": ok,
            "healthy_p99_ms": out["healthy_peer_ok_p99_ms"],
            "delayed_p99_ms": out["delayed_peer_ok_p99_ms"],
            "section_wall_s": out["section_wall_s"],
            "healthy_largest": largest_ack(traces[primary], healthy),
            "delayed_largest": largest_ack(traces[primary], delayed),
        }), flush=True)
        if args.spans:
            big = largest_ack(traces[primary], healthy)
            for i in sorted(set(range(min(8, big["acks"]))) | {big.get("op_index", 0)}):
                print(json.dumps({"run": k, "ack": i, "spans": ack_spans(
                    traces, primary, healthy, i)}), flush=True)
    print(json.dumps({"runs": args.runs, "separated": passed, "device": args.device,
                      "delay_ms": args.delay_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
