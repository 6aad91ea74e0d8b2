"""torch_cluster_top: one table for a whole cluster's health (the port).

Polls every replica's `/cluster` endpoint (`python -m
tigerbeetle_tpu_torch.cli start --metrics-port`; the port's
vsr/peerstats.cluster_status) and renders the aggregate: per replica its
view/status/commit position, and per peer LINK the replication lag,
prepare_ok latency percentiles, quorum-straggler attribution, and the
estimated clock offset/RTT — the "which replica/link is the bottleneck"
answer in one screen.

Usage:
    python tools/torch_cluster_top.py --ports 8081,8082,8083        # one shot
    python tools/torch_cluster_top.py --ports 8081,8082,8083 --watch 2
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tigerbeetle_tpu_torch.net.scrape import http_get_json  # noqa: E402


def render(statuses: List[Optional[dict]], ports: List[int]) -> str:
    """The aggregate table from per-replica /cluster documents (None =
    unreachable replica — rendered, never skipped: a dead replica is
    exactly what the operator is looking for)."""
    lines = [
        f"{'replica':>8s} {'port':>6s} {'status':>12s} {'view':>5s} "
        f"{'op':>8s} {'commit':>8s} {'skew_ms':>8s} "
        f"{'dev_mem_hw':>10s} {'inflt':>5s}"
    ]
    for i, st in enumerate(statuses):
        port = ports[i] if i < len(ports) else 0
        if st is None:
            lines.append(
                f"{'?':>8s} {port:6d} {'UNREACHABLE':>12s} "
                f"{'-':>5s} {'-':>8s} {'-':>8s} {'-':>8s} "
                f"{'-':>10s} {'-':>5s}"
            )
            continue
        role = "primary" if st.get("is_primary") else st.get("status", "?")
        skew = st.get("clock", {}).get("skew_bound_ms")
        # Device-plane columns are optional: a replica without device
        # traffic (telemetry off) reports no "device"
        # block and renders as n/a.
        dev = st.get("device", {})
        lines.append(
            f"{st.get('replica', '?'):>8} {port:6d} {role:>12s} "
            f"{st.get('view', 0):5d} {st.get('op', 0):8d} "
            f"{st.get('commit_min', 0):8d} "
            f"{skew if skew is not None else '-':>8} "
            f"{dev.get('mem_high_water_bytes', '-'):>10} "
            f"{dev.get('inflight_depth', '-'):>5}"
        )
    lines.append("")
    lines.append(
        f"{'link':>12s} {'lag_ops':>8s} {'ok_p50':>8s} {'ok_p99':>8s} "
        f"{'quorum':>7s} {'stragl':>7s} {'off_ms':>8s} {'rtt_ms':>7s} "
        f"{'conn':>5s}"
    )
    for st in statuses:
        if st is None:
            continue
        me = st.get("replica", "?")
        for rid in sorted(st.get("peers", {})):
            p = st["peers"][rid]
            lines.append(
                f"{f'{me}->{rid}':>12s} "
                f"{p.get('lag_ops', '-'):>8} "
                f"{p.get('prepare_ok_p50_ms', '-'):>8} "
                f"{p.get('prepare_ok_p99_ms', '-'):>8} "
                f"{p.get('quorum_complete', '-'):>7} "
                f"{p.get('quorum_straggler', '-'):>7} "
                f"{p.get('clock_offset_ms', '-'):>8} "
                f"{p.get('rtt_ms', '-'):>7} "
                f"{p.get('connected', '-'):>5}"
            )
    return "\n".join(lines)


def scrape(ports: List[int]) -> List[Optional[dict]]:
    out: List[Optional[dict]] = []
    for port in ports:
        try:
            out.append(http_get_json(port, "/cluster", timeout=5.0))
        except (OSError, ValueError):
            out.append(None)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="torch_cluster_top", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--ports", required=True,
                   help="comma-list of replica observability ports")
    p.add_argument("--watch", type=float, default=0.0,
                   help="refresh every N seconds (0 = one shot)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    ports = [int(x) for x in args.ports.split(",") if x.strip()]
    while True:
        print(render(scrape(ports), ports))
        if not args.watch:
            return 0
        time.sleep(args.watch)
        print()


if __name__ == "__main__":
    sys.exit(main())
