"""Merged cluster trace of the port: one Perfetto file across every replica.

Each replica's `/trace` endpoint (`python -m tigerbeetle_tpu_torch.cli
start --metrics-port`) exports its own span rings with
process-local `perf_counter` timestamps. This tool scrapes every
replica, maps each trace onto a shared WALL timeline using the
`timebase` anchor the tracer embeds (one paired perf/unix reading per
export), then corrects residual wall-clock skew between hosts with the
cluster-plane clock estimates from `/cluster` (the port's
vsr/clocksync.py —
`peers[<r>].clock_offset_ms` as estimated by the reference replica).
The result is ONE Chrome-trace JSON with a process row per replica, so
a prepare's broadcast → prepare_ok → commit is visible ACROSS lanes —
a NetFault-delayed backup shows up as a skewed lane, not a vibe.

Alignment quality is bounded by the offset estimator's error (± half
the ping RTT + tolerance, sub-millisecond on a LAN); it is a
visualization aid, never a happens-before proof.

Usage:
    # live: scrape each replica's observability port
    python tools/torch_cluster_trace.py --ports 8081,8082,8083 -o cluster.json

    # offline: merge saved /trace exports (+ optional /cluster statuses)
    python tools/torch_cluster_trace.py --traces r0.json,r1.json \
        --statuses c0.json,c1.json -o cluster.json

Open the output at ui.perfetto.dev.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tigerbeetle_tpu_torch.net.scrape import http_get_json  # noqa: E402


def _replica_of(status: Optional[dict], fallback: int) -> int:
    if isinstance(status, dict) and "replica" in status:
        return int(status["replica"])
    return fallback


def offsets_vs_reference(statuses: List[Optional[dict]]) -> List[float]:
    """Per-trace wall-clock offset in ms vs the reference replica (the
    lowest replica index present): `offset[i]` is how far replica i's
    wall clock runs AHEAD of the reference's, so subtracting it maps
    replica i's wall timestamps onto the reference timeline.

    Preference order per replica: the reference's estimate of that peer
    (one consistent observer), else the replica's own estimate of the
    reference negated, else 0 (un-estimated clocks merge unaligned)."""
    ids = [_replica_of(s, i) for i, s in enumerate(statuses)]
    ref_pos = min(range(len(ids)), key=lambda i: ids[i])
    ref_id = ids[ref_pos]
    ref_status = statuses[ref_pos] or {}
    ref_peers = ref_status.get("peers", {})
    out: List[float] = []
    for pos, status in enumerate(statuses):
        if pos == ref_pos:
            out.append(0.0)
            continue
        rid = str(ids[pos])
        est = ref_peers.get(rid, {}).get("clock_offset_ms")
        if est is None and isinstance(status, dict):
            own = status.get("peers", {}).get(str(ref_id), {})
            if own.get("clock_offset_ms") is not None:
                est = -float(own["clock_offset_ms"])
        out.append(float(est) if est is not None else 0.0)
    return out


def merge_traces(
    traces: List[dict],
    statuses: Optional[List[Optional[dict]]] = None,
    labels: Optional[List[str]] = None,
) -> dict:
    """One Chrome-trace document from per-replica exports: pid = replica
    index (process row per replica, named + sorted), event timestamps
    rebased onto the reference replica's wall timeline via each trace's
    `timebase` anchor minus the estimated clock offset."""
    if statuses is None:
        statuses = [None] * len(traces)
    else:
        # Tolerate a short/long statuses list (the CLI validates, but
        # library callers may pass partial scrapes): a missing status
        # means that trace merges with offset 0, extras are ignored.
        statuses = list(statuses[:len(traces)])
        statuses += [None] * (len(traces) - len(statuses))
    offs_ms = offsets_vs_reference(statuses)
    ids = [_replica_of(s, i) for i, s in enumerate(statuses)]
    out_events: List[dict] = []
    wall_starts: List[float] = []
    per_trace: List[List[dict]] = []
    for pos, doc in enumerate(traces):
        tb = doc.get("timebase") or {}
        # Wall µs of perf-time zero for this process; traces without an
        # anchor (pre-cluster-plane exports) stay on their raw timeline.
        base_us = (
            (tb["unix_ns"] - tb["perf_ns"]) / 1e3
            if "unix_ns" in tb and "perf_ns" in tb else 0.0
        )
        shift_us = base_us - offs_ms[pos] * 1e3
        evs = []
        for e in doc.get("traceEvents", []):
            e2 = dict(e)
            e2["pid"] = ids[pos]
            if e2.get("ph") == "X":
                e2["ts"] = e2.get("ts", 0.0) + shift_us
                wall_starts.append(e2["ts"])
            evs.append(e2)
        per_trace.append(evs)
    # Rebase to the earliest event so Perfetto doesn't render epoch-scale
    # offsets.
    t0 = min(wall_starts) if wall_starts else 0.0
    for pos, evs in enumerate(per_trace):
        label = (
            labels[pos] if labels and pos < len(labels)
            else f"replica {ids[pos]}"
        )
        out_events.append({
            "name": "process_name", "ph": "M", "pid": ids[pos],
            "args": {"name": label},
        })
        out_events.append({
            "name": "process_sort_index", "ph": "M", "pid": ids[pos],
            "args": {"sort_index": ids[pos]},
        })
        for e in evs:
            if e.get("ph") == "X":
                e["ts"] -= t0
            out_events.append(e)
    return {
        "traceEvents": out_events,
        "displayTimeUnit": "ms",
        "clusterAlignment": {
            "reference_replica": min(ids),
            "offsets_ms": {str(ids[i]): offs_ms[i] for i in range(len(ids))},
        },
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="torch_cluster_trace", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--ports", default=None,
                   help="comma-list of replica observability ports to "
                        "scrape (/trace + /cluster per replica)")
    p.add_argument("--traces", default=None,
                   help="comma-list of saved /trace JSON files (offline)")
    p.add_argument("--statuses", default=None,
                   help="comma-list of saved /cluster JSON files matching "
                        "--traces (optional: offsets default to 0)")
    p.add_argument("-o", "--out", required=True,
                   help="where to write the merged Chrome-trace JSON")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    if bool(args.ports) == bool(args.traces):
        p.error("exactly one of --ports / --traces is required")
    labels = None
    if args.ports:
        ports = [int(x) for x in args.ports.split(",") if x.strip()]
        traces, statuses, labels = [], [], []
        for port in ports:
            traces.append(http_get_json(port, "/trace"))
            try:
                st = http_get_json(port, "/cluster")
            except (OSError, ValueError):
                st = None
            statuses.append(st)
            rid = _replica_of(st, len(labels))
            labels.append(f"replica {rid} (:{port})")
    else:
        traces = [json.load(open(f)) for f in args.traces.split(",") if f]
        statuses = (
            [json.load(open(f)) for f in args.statuses.split(",") if f]
            if args.statuses else None
        )
        if statuses is not None and len(statuses) != len(traces):
            p.error(
                f"--statuses lists {len(statuses)} files but --traces "
                f"lists {len(traces)} — they must match positionally"
            )
    merged = merge_traces(traces, statuses, labels)
    with open(args.out, "w") as f:
        json.dump(merged, f)
    align = merged["clusterAlignment"]
    print(
        f"merged {len(traces)} replica traces -> {args.out} "
        f"(reference replica {align['reference_replica']}, offsets_ms="
        f"{align['offsets_ms']}) — open at ui.perfetto.dev"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
