"""Per-peer replication telemetry on the primary (the cluster plane).

The op lifecycle (tracer.op_*) decomposes a prepare per replica, but
its `quorum` component is one opaque wait with no attribution to the
peer that was slow. This module stamps the replication plane itself:

  broadcast      `_primary_prepare` opens the window on the op's pooled
                 OpRecord (`peer_bcast`) as the prepare leaves for the
                 chain — allocation-free, same discipline as the
                 lifecycle stamps.
  per-peer ack   every prepare_ok arrival (and the primary's own
                 WAL-durable self-ack) stamps `peer_t[replica]`,
                 feeding `vsr.peer.<r>.prepare_ok` histograms and the
                 aggregate `vsr.replication.lag` distribution (REMOTE
                 acks only — the gated replication_lag_p99_ms).
  quorum point   the q-th arrival stamps `quorum_t` and counts
                 `vsr.peer.<r>.quorum_complete` for the peer that
                 completed it; later arrivals count
                 `vsr.peer.<r>.quorum_straggler` and observe their
                 overhang past the quorum point into
                 `vsr.quorum.straggler` (gated quorum_straggler_p99_ms).
                 On a 3-replica cluster the single straggler's overhang
                 IS the q-th→last-arrival distance; with more stragglers
                 the histogram holds one sample per straggler and its
                 tail is the last arrival.
  lag gauges     `commit_sample()` re-publishes `vsr.peer.<r>.
                 replication_lag_ops` (primary tip vs the peer's
                 highest acked op) once per commit round.

Ops are tracked past their pipeline pop (bounded by TRACK_MAX) so
stragglers arriving AFTER quorum committed still attribute; `peers_open`
on the record keeps the flight-ring eviction from recycling a record a
late ack could still stamp. On view change `close_all()` drops every
partial window — partial records are never fabricated into full ones.

All methods run on the primary's loop thread (the same thread that owns
the pipeline); the tracer registry is the only cross-thread surface.
Everything here is observability: no replicated state is read or
written, and the telemetry-on-vs-off determinism guard proves it.
"""

from __future__ import annotations

import time
from typing import Dict, List

from tigerbeetle_tpu_torch import tracer

# Ops tracked past quorum for straggler attribution. A peer that has
# not acked within 256 ops of the tip is attributed as "never arrived"
# (its window closes unstamped) — the lag gauges keep naming it.
TRACK_MAX = 256

# Preformatted per-peer event names: the ack path runs per prepare_ok
# on the loop thread and must not pay an f-string per message.
_OK_EVENT = tuple(
    f"vsr.peer.{r}.prepare_ok" for r in range(tracer.OP_PEER_MAX)
)
_COMPLETE = tuple(
    f"vsr.peer.{r}.quorum_complete" for r in range(tracer.OP_PEER_MAX)
)
_STRAGGLER = tuple(
    f"vsr.peer.{r}.quorum_straggler" for r in range(tracer.OP_PEER_MAX)
)
_LAG_GAUGE = tuple(
    f"vsr.peer.{r}.replication_lag_ops" for r in range(tracer.OP_PEER_MAX)
)


class PeerStats:
    """Loop-thread-owned per-peer replication tracker (primary side)."""

    def __init__(self, replica_index: int, replica_count: int) -> None:
        self.me = replica_index
        self.replica_count = min(replica_count, tracer.OP_PEER_MAX)
        # op -> OpRecord with an open peer window, insertion order = op
        # order (dict semantics), so eviction pops the oldest op.
        self._track: Dict[int, object] = {}  # tidy: owner=loop
        # Highest op each active replica has acked (self included via
        # the WAL-durable self-ack).
        self.acked_op: List[int] = [0] * self.replica_count  # tidy: owner=loop

    # --- window lifecycle -----------------------------------------------

    def broadcast(self, op: int, rec) -> None:
        """The primary proposed `op`: open its peer window at broadcast
        time. rec is the op's pooled lifecycle record (None when tracing
        is disabled — the whole cluster plane then costs one None check
        per prepare)."""
        if rec is None:
            return
        rec.peer_bcast = time.perf_counter_ns()  # tidy: allow=wall-clock — peer telemetry only, never reaches replicated state
        rec.peers_open = True
        self._track[op] = rec
        if len(self._track) > TRACK_MAX:
            self._release(next(iter(self._track)))

    def _release(self, op: int) -> None:
        rec = self._track.pop(op, None)
        if rec is not None:
            # Clears peers_open, and re-offers the record to the pool
            # if the flight ring already evicted it past us (a down
            # peer keeps windows open for TRACK_MAX ops — the pool must
            # not starve for the whole outage).
            tracer.op_peer_release(rec)

    def ack(self, op: int, replica: int, quorum: int) -> None:
        """A prepare_ok from `replica` (or the local WAL-durable
        self-ack) for `op`. Duplicates and untracked ops are no-ops;
        quorum is the replication quorum size at this cluster size."""
        if not 0 <= replica < self.replica_count:
            return
        if op > self.acked_op[replica]:
            self.acked_op[replica] = op
        rec = self._track.get(op)
        if rec is None or rec.peer_t[replica]:
            return
        now = time.perf_counter_ns()  # tidy: allow=wall-clock — peer telemetry only, never reaches replicated state
        rec.peer_t[replica] = now
        if replica != self.me and rec.peer_bcast:
            dt = now - rec.peer_bcast
            tracer.observe(_OK_EVENT[replica], dt)
            tracer.observe("vsr.replication.lag", dt)
        if rec.quorum_t:
            # Post-quorum straggler: name the peer and observe how far
            # past the quorum point its ack landed. The attribution
            # counter includes SELF (a slow local group-fsync arriving
            # after both backups is a real diagnosis), but the gated
            # overhang histogram is remote-only, matching the
            # prepare_ok/replication-lag histograms — the
            # quorum_straggler_p99_ms baseline must measure peer LINKS,
            # not local fsync latency.
            tracer.count(_STRAGGLER[replica])
            if replica != self.me:
                tracer.observe("vsr.quorum.straggler", now - rec.quorum_t)
        elif self._acks(rec) >= quorum:
            rec.quorum_t = now
            rec.quorum_peer = replica
            tracer.count(_COMPLETE[replica])
        if self._acks(rec) >= self.replica_count:
            self._release(op)  # every active replica answered

    @staticmethod
    def _acks(rec) -> int:
        pt = rec.peer_t
        return sum(1 for i in range(tracer.OP_PEER_MAX) if pt[i])

    def commit_sample(self, op: int, commit_min: int) -> None:
        """Per-commit replication-lag gauges: primary tip (`op`) vs each
        peer's highest acked op. commit_min rides along in /cluster; the
        gauge uses the tip, which is what a stalled peer lags behind."""
        for r in range(self.replica_count):
            if r != self.me:
                tracer.gauge(_LAG_GAUGE[r], max(0, op - self.acked_op[r]))

    def close_all(self) -> None:
        """Leaving normal/primary status (view change): close every
        partial window. The partial records keep whatever stamps landed
        — never fabricated into full ones — and become recyclable."""
        for rec in self._track.values():
            tracer.op_peer_release(rec)
        self._track.clear()

    def tracked(self) -> int:
        return len(self._track)


def cluster_status(replica, server=None) -> dict:
    """The /cluster endpoint body: this replica's view/commit position
    plus per-peer health — replication lag, prepare_ok latency
    percentiles, quorum attribution counters, clock offset/RTT, bus
    byte counters, connectivity — in one JSON table. The clock estimates
    and the timebase let per-replica traces be merged onto one timeline."""
    snap = tracer.snapshot()
    ps = getattr(replica, "peer_stats", None)
    cs = getattr(replica, "clocksync", None)
    clock_est = cs.estimate() if cs is not None else {}
    peers: Dict[str, dict] = {}
    for r in range(replica.replica_count):
        if r == replica.replica:
            continue
        p: dict = {}
        if ps is not None and r < len(ps.acked_op) and replica.is_primary:
            # Ack tracking is primary-side state: a backup never receives
            # prepare_oks, so publishing its (stale-zero) acked_op would
            # read as every peer lagging the whole log.
            p["acked_op"] = ps.acked_op[r]
            p["lag_ops"] = max(0, replica.op - ps.acked_op[r])
        ok = snap.get(_OK_EVENT[r]) if r < tracer.OP_PEER_MAX else None
        if ok is not None:
            p["prepare_ok_count"] = ok.get("count", 0)
            p["prepare_ok_p50_ms"] = round(ok.get("p50_us", 0.0) / 1e3, 3)
            p["prepare_ok_p99_ms"] = round(ok.get("p99_us", 0.0) / 1e3, 3)
        for label, events in (
            ("quorum_complete", _COMPLETE), ("quorum_straggler", _STRAGGLER),
        ):
            if r < tracer.OP_PEER_MAX:
                p[label] = snap.get(events[r], {}).get("count", 0)
        p.update(clock_est.get(r, {}))
        for key in ("tx_messages", "tx_bytes", "rx_messages", "rx_bytes"):
            row = snap.get(f"bus.peer.{r}.{key}")
            if row is not None:
                p[key] = row.get("count", 0)
        if server is not None:
            p["connected"] = int(r in server.peer_conns)
        peers[str(r)] = p
    out = {
        "replica": replica.replica,
        "replica_count": replica.replica_count,
        "view": replica.view,
        "status": replica.status,
        "is_primary": int(replica.is_primary),
        "op": replica.op,
        "commit_min": replica.commit_min,
        "commit_max": replica.commit_max,
        "peers": peers,
        # Same anchor pair as export_trace(): lets the merged-trace tool
        # map this process's perf_counter timestamps onto wall time.
        "timebase": {
            "perf_ns": time.perf_counter_ns(),  # tidy: allow=wall-clock — scrape-surface timebase anchor, observability only
            "unix_ns": time.time_ns(),  # tidy: allow=wall-clock — scrape-surface timebase anchor, observability only
        },
    }
    if cs is not None and cs.skew_bound_ns is not None:
        out["clock"] = {
            "skew_bound_ms": round(cs.skew_bound_ns / 1e6, 3),
            "sources": cs.sources,
        }
    # Device-plane summary (tracer-side ledgers only — no devicestats
    # import, so the scrape reads no device):
    # cluster_top renders these as optional columns, n/a when absent.
    mem = tracer.device_mem_totals()
    inflight = tracer.device_inflight()
    if mem["owners"] or inflight["window_depth"]:
        out["device"] = {
            "mem_high_water_bytes": mem["high_water_bytes"],
            "mem_total_bytes": mem["total_bytes"],
            "inflight_depth": inflight["window_depth"],
        }
    return out


def commit_status(replica) -> dict:
    """The /commits endpoint body: this replica's commit checksum of
    every op it holds one for (hex, by op) and the section digests of its
    current checkpoint trailer (sha256 hex, client_replies excluded: the
    one per-replica section), so that a harness can hold a standby's
    chain and checkpoint to the actives' across processes."""
    import hashlib
    import io

    import numpy as np

    out = {
        "replica": replica.replica,
        "standby": bool(replica.is_standby),
        "commit_min": replica.commit_min,
        "checksums": {str(op): f"{v:032x}"
                      for op, v in sorted(replica.commit_checksums.items())},
        "checkpoint": {"op": 0, "trailer": {}},
    }
    st = replica.superblock.state
    if st.op_checkpoint:
        blob, _blocks = replica._trailer_blob(st.trailer_block)
        with np.load(io.BytesIO(blob)) as z:
            out["checkpoint"] = {"op": st.op_checkpoint, "trailer": {
                k: hashlib.sha256(np.ascontiguousarray(z[k]).tobytes()).hexdigest()
                for k in sorted(z.files) if k != "client_replies"}}
    return out

