"""Fault-tolerant cluster clock: offset sampling over ping/pong + Marzullo.

Mirrors upstream src/vsr/clock.zig: each replica
samples its clock offset against every peer from ping/pong round trips
(remote wall time ± half the round trip, clock.zig window learning), keeps
the lowest-RTT sample per peer per window, and at window close runs
Marzullo's interval agreement (vsr/marzullo.py) over all sources including
itself. If a quorum of intervals overlap, the epoch is synchronized and
`realtime_synchronized()` bounds the local wall clock into the agreed
offset interval — so one wildly-wrong local clock cannot poison the
primary's prepare timestamps.

Time sources are injected (`monotonic_ns()` / `realtime_ns()`): production
uses SystemTime; tests and the simulator use DeterministicTime, keeping
whole-cluster runs byte-reproducible (reference comptime Time injection,
replica.zig:121).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from tigerbeetle_tpu_torch.vsr.marzullo import Interval, smallest_interval

NS_PER_MS = 1_000_000

# Static one-way error added to every sample (clock.zig tolerance: clock
# granularity + scheduling jitter).
TOLERANCE_NS = 10 * NS_PER_MS
# Sample window length before attempting synchronization (clock.zig
# window_max; short enough to track drift, long enough to catch a good RTT).
WINDOW_NS = 2_000 * NS_PER_MS
# Discard samples with absurd round trips (clock.zig rtt_max).
RTT_MAX_NS = 1_000 * NS_PER_MS
# Without a fresh synchronization for this long, drop back to
# unsynchronized rather than applying a drift-stale offset
# (clock.zig:275-281 clock_epoch_max).
EPOCH_MAX_NS = 60_000 * NS_PER_MS


class SystemTime:
    """Production time source."""

    def monotonic_ns(self) -> int:
        import time

        return time.monotonic_ns()

    def realtime_ns(self) -> int:
        import time

        return time.time_ns()


class DeterministicTime:
    """Seedless, manually-advanced time for tests and the simulator.

    `offset_ns` models a skewed wall clock against the shared simulated
    monotonic timeline.
    """

    def __init__(self, offset_ns: int = 0, tick_ns: int = 10 * NS_PER_MS) -> None:
        self.ticks = 0
        self.tick_ns = tick_ns
        self.offset_ns = offset_ns

    def tick(self) -> None:
        self.ticks += 1

    def monotonic_ns(self) -> int:
        return self.ticks * self.tick_ns

    def realtime_ns(self) -> int:
        return self.ticks * self.tick_ns + self.offset_ns


@dataclass
class _Sample:
    rtt_ns: int
    offset_lo: int
    offset_hi: int


class Clock:
    """Per-replica cluster clock (reference ClockType, clock.zig:15)."""

    def __init__(self, time, replica_count: int, replica_index: int) -> None:
        self.time = time
        self.replica_count = replica_count
        self.replica = replica_index
        # Majority including self (clock.zig quorum: > half the cluster;
        # a solo cluster is trivially synchronized to itself).
        self.quorum = replica_count // 2 + 1
        self.window_start_ns = time.monotonic_ns()
        self.samples: Dict[int, _Sample] = {}
        self.synchronized: Optional[Interval] = None
        # Epoch anchors: the monotonic/wall readings at synchronization
        # time. realtime_synchronized() projects wall time forward from
        # these via monotonic elapsed time, so a post-epoch wall-clock
        # step cannot leak through (clock.zig:254-266).
        self.epoch_monotonic_ns = 0
        self.epoch_realtime_ns = 0
        self.epochs = 0

    # --- sampling (driven by replica ping/pong) -------------------------

    def ping_timestamp(self) -> int:
        """Monotonic stamp to embed in an outgoing ping."""
        return self.time.monotonic_ns()

    def learn(self, replica: int, m0: int, t_remote: int, m1: int) -> None:
        """Ingest one pong: we pinged at monotonic m0, the peer answered
        with its wall time t_remote, we received at monotonic m1
        (clock.zig learn)."""
        if replica == self.replica:
            return
        rtt = m1 - m0
        if rtt < 0 or rtt > RTT_MAX_NS:
            return
        if m0 < self.window_start_ns:
            return  # sample straddles a window boundary
        best = self.samples.get(replica)
        if best is not None and best.rtt_ns <= rtt:
            return
        # The peer's wall clock read happened somewhere inside the round
        # trip; assume the midpoint and widen by half the RTT + tolerance.
        t_local_mid = self.time.realtime_ns() - (m1 - m0) // 2 - (
            self.time.monotonic_ns() - m1
        )
        offset = t_remote - t_local_mid
        err = rtt // 2 + TOLERANCE_NS
        self.samples[replica] = _Sample(rtt, offset - err, offset + err)

    # --- synchronization ------------------------------------------------

    def tick(self) -> None:
        """Advance; close the sample window when it expires; expire a stale
        epoch that hasn't re-synchronized within EPOCH_MAX_NS."""
        now = self.time.monotonic_ns()
        if (
            self.synchronized is not None
            and now - self.epoch_monotonic_ns > EPOCH_MAX_NS
        ):
            self.synchronized = None  # clock.zig: "no agreement on cluster time"
        if now - self.window_start_ns < WINDOW_NS:
            return
        self._synchronize()
        self.window_start_ns = now
        self.samples = {}

    def _synchronize(self) -> None:
        if self.replica_count == 1:
            self._set_epoch(Interval(0, 0, 1))
            return
        tuples: List[Tuple[int, int]] = [(0, 0)]  # self: zero offset, exact
        for s in self.samples.values():
            tuples.append((s.offset_lo, s.offset_hi))
        interval = smallest_interval(tuples)
        if interval.sources_true >= self.quorum:
            self._set_epoch(interval)
        # else: keep the previous epoch until it expires (EPOCH_MAX_NS).

    def _set_epoch(self, interval: Interval) -> None:
        self.synchronized = interval
        self.epoch_monotonic_ns = self.time.monotonic_ns()
        self.epoch_realtime_ns = self.time.realtime_ns()
        self.epochs += 1

    def realtime_synchronized(self) -> Optional[int]:
        """Local wall time bounded by the cluster-agreed offset interval,
        projected forward from the epoch anchors via monotonic elapsed
        time (clock.zig:254-266) — immune to post-epoch wall-clock steps.
        None until a first synchronization (the primary then falls back to
        its raw clock, reference replica.zig:1323 handles the same case)."""
        if self.synchronized is None:
            return None
        elapsed = self.time.monotonic_ns() - self.epoch_monotonic_ns
        projected = self.epoch_realtime_ns + elapsed
        lo = projected + self.synchronized.lower_bound
        hi = projected + self.synchronized.upper_bound
        return min(max(self.time.realtime_ns(), lo), hi)
