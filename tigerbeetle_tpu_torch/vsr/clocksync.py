"""Per-peer clock-offset / RTT telemetry over the PING/PONG exchange.

The reference's clock.zig both ESTIMATES peer offsets and FEEDS the
agreed interval into the primary's prepare timestamps. This repo splits
the two: vsr/clock.py is the state-machine half (Marzullo-synchronized
timestamps enter replicated state only through prepare headers), and
this module is the OBSERVABILITY half — per-peer (offset, RTT) sample
windows published as `vsr.peer.<r>.clock_offset_ms` / `rtt_ms` gauges,
plus a worst-case pairwise cluster skew bound
(`vsr.clock.skew_bound_ms`, the span across all sources' offset
intervals) and Marzullo's agreement count (`vsr.clock.sources`, how
many sources still share a common offset) over the freshest per-peer
estimates.

Estimation ONLY — a hard non-goal is feeding the deterministic state
machine: nothing here is read by commit/prepare paths, every input
(ping stamp, pong wall time, receive stamp) is passed in by the
caller, and the telemetry-on-vs-off cluster determinism guard
(tests/test_cluster_plane.py) proves removing it changes no replicated
byte. The replica wires `learn()` from on_pong with the SAME values it
already hands vsr/clock.py, so no extra wire field and no extra clock
read exists because of this module.

All state is loop-thread-owned (samples arrive and are retired on the
replica's event loop); the only cross-thread surface is the tracer
gauge registry, which takes its own lock.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional, Tuple

from tigerbeetle_tpu_torch import tracer
from tigerbeetle_tpu_torch.vsr.marzullo import smallest_interval

NS_PER_MS = 1_000_000
# Samples retained per peer: enough to ride out one slow ping round
# while still tracking drift at the 0.5 s ping cadence.
WINDOW_SAMPLES = 16
# Same sanity bounds as the state-machine clock (vsr/clock.py): a
# multi-second round trip estimates nothing.
RTT_MAX_NS = 1_000 * NS_PER_MS
TOLERANCE_NS = 10 * NS_PER_MS


class ClockSync:
    """Per-peer offset/RTT estimator (telemetry-only clock.zig analog)."""

    def __init__(self, replica_index: int, replica_count: int) -> None:
        self.replica = replica_index
        self.replica_count = replica_count
        # Majority including self, like the state-machine clock: the
        # skew bound is published only when a quorum of sources agree.
        self.quorum = replica_count // 2 + 1
        # peer -> deque[(offset_ns, rtt_ns)], newest right.
        self.samples: Dict[int, deque] = {}  # tidy: owner=loop
        # Latest published skew bound (ns width of the agreed interval),
        # None before first agreement — mirrored as gauges.
        self.skew_bound_ns: Optional[int] = None  # tidy: owner=loop
        self.sources = 0  # tidy: owner=loop

    # --- sampling (driven by replica on_pong) ---------------------------

    def learn(
        self, replica: int, m0: int, t_remote: int, m1: int,
        realtime_ns: int, monotonic_ns: int,
    ) -> None:
        """Ingest one pong: we pinged at monotonic m0, the peer answered
        with wall time t_remote, we received at monotonic m1; the caller
        also passes its current wall/monotonic readings (this module
        never reads a clock itself — the replica's injected time source
        stays the single reader, so simulator runs stay reproducible)."""
        if replica == self.replica or replica >= self.replica_count:
            return
        rtt = m1 - m0
        if rtt < 0 or rtt > RTT_MAX_NS:
            return
        # The peer's wall read happened somewhere inside the round trip;
        # assume the midpoint (same estimator as vsr/clock.py learn).
        t_local_mid = realtime_ns - rtt // 2 - (monotonic_ns - m1)
        offset = t_remote - t_local_mid
        dq = self.samples.get(replica)
        if dq is None:
            dq = self.samples[replica] = deque(maxlen=WINDOW_SAMPLES)
        dq.append((offset, rtt))
        if tracer.enabled():
            best_off, best_rtt = self.best(replica)
            tracer.gauge(
                f"vsr.peer.{replica}.clock_offset_ms",
                round(best_off / NS_PER_MS, 3),
            )
            tracer.gauge(
                f"vsr.peer.{replica}.rtt_ms", round(best_rtt / NS_PER_MS, 3)
            )
            self._publish_skew()

    def best(self, replica: int) -> Tuple[int, int]:
        """(offset_ns, rtt_ns) of the window's min-RTT sample — the
        tightest error bound (clock.zig keeps exactly this per window)."""
        dq = self.samples.get(replica)
        if not dq:
            return 0, 0
        return min(dq, key=lambda s: s[1])

    # --- aggregation ----------------------------------------------------

    def _intervals(self):
        """[(lo, hi)] offset intervals: self (exact zero) + each peer's
        best sample widened by half its RTT + tolerance."""
        tuples = [(0, 0)]
        for r in self.samples:
            off, rtt = self.best(r)
            err = rtt // 2 + TOLERANCE_NS
            tuples.append((off - err, off + err))
        return tuples

    def _publish_skew(self) -> None:
        """Re-derive the cluster clock gauges from the current windows.

        `skew_bound_ms` is the worst-case PAIRWISE skew bound: the span
        from the lowest interval edge to the highest across all sources
        (self at exactly 0). NOT the width of Marzullo's agreed
        intersection — with self as a zero-width source that width
        collapses to 0 whenever the local clock sits inside the
        majority, hiding exactly the 500 ms-stepped peer it should
        surface. A healthy LAN cluster therefore reads ~2×(rtt/2 +
        tolerance) — the measurement precision floor — and a stepped
        peer's offset lands on top of it. `sources` stays Marzullo's
        agreement count: how many sources still share a common offset
        (a step drops it while the skew bound jumps).

        Published while windows exist for a quorum of sources; WITHDRAWN
        when retirements drop below that — a partitioned replica must
        not keep serving a healthy-looking bound forever."""
        tuples = self._intervals()
        if len(tuples) >= self.quorum:
            self.skew_bound_ns = (
                max(hi for _, hi in tuples) - min(lo for lo, _ in tuples)
            )
            self.sources = smallest_interval(tuples).sources_true
            tracer.gauge(
                "vsr.clock.skew_bound_ms",
                round(self.skew_bound_ns / NS_PER_MS, 3),
            )
            tracer.gauge("vsr.clock.sources", self.sources)
        elif self.skew_bound_ns is not None:
            self.skew_bound_ns = None
            self.sources = 0
            tracer.remove_gauge("vsr.clock.skew_bound_ms")
            tracer.remove_gauge("vsr.clock.sources")

    def estimate(self) -> Dict[int, dict]:
        """Per-peer snapshot for the /cluster endpoint and the merged-
        trace aligner: offset/RTT of the best sample + window depth."""
        out: Dict[int, dict] = {}
        for r, dq in self.samples.items():
            off, rtt = self.best(r)
            out[r] = {
                "clock_offset_ms": round(off / NS_PER_MS, 3),
                "rtt_ms": round(rtt / NS_PER_MS, 3),
                "samples": len(dq),
            }
        return out

    # --- lifecycle ------------------------------------------------------

    def retire(self, replica: int) -> None:
        """Drop a peer's window when its connection unmaps (the per-peer
        gauge retirement itself is done by Replica.peer_unmapped, which
        owns the whole vsr.peer.<r>.* family). The AGGREGATE skew bound
        re-derives immediately from the survivors — and is WITHDRAWN
        when they no longer reach quorum: a partitioned replica must not
        keep serving a healthy-looking sub-ms bound on every scrape
        (the same stale-gauge class peer_unmapped exists to prevent)."""
        if self.samples.pop(replica, None) is None:
            return
        self._publish_skew()
