"""torch_device_top: one screen for what the card is doing, per replica.

Polls every replica's `/device` endpoint (`python -m
tigerbeetle_tpu_torch.cli start --metrics-port`; the port's
devicestats.device_status) and renders the device plane: the per-kernel
cost and roofline table (the bytes and operations of each observed call
shape joined with its measured window times into calls, ms per call,
achieved GB/s, the share of the least time and the roofline side), the
owner-tagged device memory ledger with its high-water mark beside the
CUDA allocator's own report, transfer bandwidth per direction, and the
open dispatch windows.

Every column degrades to '-' where a replica does not report it (a CPU
replica, the tracer off): n/a is an answer, never an error.

Usage:
    python tools/torch_device_top.py --ports 8081                 # one shot
    python tools/torch_device_top.py --ports 8081,8082 --watch 2
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


def _fmt(v, nd: int = 3):
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}".rstrip("0").rstrip(".") or "0"
    return v


def render(statuses: List[Optional[dict]], ports: List[int]) -> str:
    """The device-plane tables from per-replica /device documents (None
    = unreachable replica: rendered, never skipped)."""
    lines: List[str] = []
    for i, st in enumerate(statuses):
        port = ports[i] if i < len(ports) else 0
        if st is None:
            lines.append(f"port {port}: UNREACHABLE")
            continue
        depth = st.get("inflight", {}).get("window_depth", 0)
        lines.append(
            f"port {port}: backend={st.get('backend', '?')} "
            f"card={st.get('device_name', '-')} "
            f"tracing={int(bool(st.get('tracing')))} "
            f"commit_depth={st.get('commit_depth', '-')} "
            f"inflight_depth={depth}"
        )
        rows = st.get("entries", [])
        if rows:
            lines.append(
                f"  {'entry':<26s} {'shape':<28s} {'calls':>7s} "
                f"{'ms/call':>8s} {'MB':>9s} {'gbps':>9s} "
                f"{'bound_ms':>9s} {'share':>7s} {'bound':>10s}"
            )
            for r in rows:
                shape = str(r.get("shape", ""))
                if len(shape) > 28:
                    shape = shape[:25] + "..."
                nbytes = r.get("bytes")
                lines.append(
                    f"  {r.get('entry', '?'):<26s} {shape:<28s} "
                    f"{_fmt(r.get('calls')):>7} "
                    f"{_fmt(r.get('ms_per_call'), 4):>8} "
                    f"{_fmt(None if nbytes is None else nbytes / 1e6, 2):>9} "
                    f"{_fmt(r.get('achieved_gbps')):>9} "
                    f"{_fmt(r.get('bound_ms'), 5):>9} "
                    f"{_fmt(r.get('bound_share'), 4):>7} "
                    f"{r.get('bound', 'n/a'):>10s}"
                )
        mem = st.get("mem", {})
        owners = mem.get("owners", {})
        if owners or mem.get("high_water_bytes") or mem.get("backend_reported"):
            lines.append(
                f"  mem: total={_fmt(mem.get('total_bytes'))} "
                f"high_water={_fmt(mem.get('high_water_bytes'))}"
            )
            for owner in sorted(owners):
                lines.append(f"    {owner:<28s} {owners[owner]:>12d}")
            card = mem.get("backend_reported")
            if card:
                lines.append(
                    f"    allocator: in_use={_fmt(card.get('bytes_in_use'))} "
                    f"peak={_fmt(card.get('peak_bytes_in_use'))} "
                    f"reserved={_fmt(card.get('reserved_bytes'))}"
                )
        xfer = st.get("xfer", {})
        if xfer.get("h2d_bytes") or xfer.get("d2h_bytes"):
            lines.append(
                f"  xfer: h2d={xfer.get('h2d_bytes', 0)}B "
                f"@p50 {_fmt(xfer.get('h2d_gbps_p50'))} GB/s  "
                f"d2h={xfer.get('d2h_bytes', 0)}B "
                f"@p50 {_fmt(xfer.get('d2h_gbps_p50'))} GB/s  "
                f"bytes/transfer={_fmt(xfer.get('bytes_per_transfer'))}"
            )
    return "\n".join(lines)


def scrape(ports: List[int]) -> List[Optional[dict]]:
    out: List[Optional[dict]] = []
    for port in ports:
        try:
            out.append(http_get_json(port, "/device", timeout=5.0))
        except (OSError, ValueError):
            out.append(None)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="torch_device_top", description=__doc__,
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
