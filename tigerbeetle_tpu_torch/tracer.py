"""Spans, counters, gauges, device windows and the per-op lifecycle: the
port of the reference package's tracer.py, recorded the way it records.

Thread model (the reference's): every recording path (`span`, `observe`,
`count`) writes only its own thread's arena, created at the thread's
first record and registered for the merge; after that first record it
takes no lock and allocates nothing (span objects are pooled per thread,
ring slots are preallocated arrays). Each thread keeps its own bounded
ring of span records, `configure(ring_size)` records per thread, so a
busy thread never evicts another's timeline. `snapshot()` and
`trace_events()` read across the arenas without stopping their writers
(exact once they quiesce). `reset()` bumps a generation: threads
re-create their arena at their next record, so no cross-thread mutation
races a writer. The arena of a thread that died stays, ring and all,
until DEAD_ARENAS_MAX younger dead arenas exist; then its aggregates
fold into the registry and its ring goes (snapshot totals unchanged).

  - `span(event)` times a scoped host region; `observe(event, ns)`
    records a duration the caller measured: per-event count, total, max
    and a log-bucketed histogram, plus the thread's span ring.
  - `count` (per thread, exact under concurrent bumps) / `gauge`
    (last-write-wins, under the registry lock).
  - `device_mem_set` / `device_mem_adjust` / `device_mem_release` /
    `device_mem_retire_prefix`: the owner-tagged device memory ledger
    (`device.mem.<owner>.bytes` gauges plus a high-water total).
  - `device_step(entry)`: a span over a blocking kernel call. Entry
    names are checked against tidy/manifest.KERNEL_ENTRIES (the list
    the host-sync pass reads; `sharded.<entry>` on a mesh) or
    `register_device_entry`.
  - `device_dispatch(entry)` / `device_finish(entry, token)`: the
    split-phase window. On a CUDA stream the token carries a CUDA event
    recorded at dispatch; finish records a second event, waits for it (it
    runs only where the caller synchronises anyway) and records the
    device time between the two under `device.step.<entry>`. Off CUDA the
    window is the host clock between the two calls. Open windows are
    bounded per entry (an abandoned one is evicted, never leaked).
  - `op_begin` / `op_stamp` / `op_finish` / `op_store_done`: one record
    per prepare, stamped at every pipeline hand-off, whose components
    land in the span registry (`op.queue.*`, `op.service.*`).
  - `flight_trip` / `flight_exception`: keep the last completed op
    records (and the device windows and memory ledger) for post-hoc
    inspection of a tail anomaly or a pipeline exception (in memory,
    `flight_dumps()`, and as files when `configure_flight(directory=...)`
    names a directory: `tools/trace_summary.py --ops` reads them);
    `flight_records()` is the completed-op ring itself and
    `configure_flight` sets the recorder's policy and the ring's size.
  - The scrape surface: `snapshot()` (p50/p95/p99 from the merged
    histograms), `lifecycle_summary()`, `emit_json()`, `trace_events()`
    / `export_trace()` (Chrome trace-event JSON: one named lane per
    thread, and the closed device windows as async pairs),
    `prometheus_text()`, `dump(path)` (the trace as a Perfetto-loadable
    file), and `serve_metrics(port)`, which serves `/metrics`, `/trace`,
    `/lifecycle` and `/flight` (plus caller routes) from the replica's
    own asyncio loop.

Off until `enable()`; disabled, every call returns after one
module-global check and allocates nothing. The port reads no
environment variable: `configure` and `configure_flight` set what the
reference reads from one.
"""

from __future__ import annotations

import json
import os
import threading
import time
from array import array
from collections import deque
from typing import Dict, List, Optional, Tuple

from tigerbeetle_tpu_torch.tidy import manifest

_enabled = False

# --- histogram geometry (log-linear) --------------------------------------
#
# Values are nanoseconds. 2^HIST_SUB_BITS sub-buckets per power of two
# bound the relative quantization error at 12.5%; the buckets cover the
# whole u64 range, so a merge is an elementwise sum.

HIST_SUB_BITS = 3
_HIST_SUB = 1 << HIST_SUB_BITS
HIST_BUCKETS = (64 - HIST_SUB_BITS) * _HIST_SUB
_HIST_ZEROS = bytes(8 * HIST_BUCKETS)


def bucket_index(v: int) -> int:
    """Histogram bucket for a nanosecond value (v >= 0)."""
    if v < _HIST_SUB:
        return v
    msb = v.bit_length() - 1
    return ((msb - HIST_SUB_BITS + 1) << HIST_SUB_BITS) + (
        (v >> (msb - HIST_SUB_BITS)) - _HIST_SUB
    )


def bucket_value(idx: int) -> int:
    """Representative (midpoint) nanosecond value of a bucket."""
    if idx < 2 * _HIST_SUB:
        return idx
    octave = idx >> HIST_SUB_BITS
    sub = idx & (_HIST_SUB - 1)
    shift = octave - 1
    lo = (_HIST_SUB + sub) << shift
    return lo + ((1 << shift) - 1) // 2


def _hist_percentile(buckets, total: int, q: float) -> int:
    """q-quantile in nanoseconds from a bucket array."""
    if total <= 0:
        return 0
    rank = q * (total - 1)
    cum = 0
    for i, c in enumerate(buckets):
        if c:
            cum += c
            if cum > rank:
                return bucket_value(i)
    return bucket_value(HIST_BUCKETS - 1)


# --- per-thread recording state -------------------------------------------

RING_DEFAULT = 1 << 15  # span records per thread (~0.75 MiB each)
# Arenas of dead threads kept whole (ring included) before the oldest
# fold into the registry's retired table.
DEAD_ARENAS_MAX = 16

_ring_size = RING_DEFAULT
_registry_lock = threading.Lock()
_states: List["_ThreadState"] = []  # tidy: guarded-by=_registry_lock
_generation = 0
# The folded aggregates of dead threads' arenas: [agg, hist, counters],
# the same tables an arena holds.
_retired = [{}, {}, {}]  # tidy: guarded-by=_registry_lock
# Gauges are last-write-wins from any thread while a scrape iterates
# them, so even the single-key set takes the lock.
_gauges: Dict[str, float] = {}  # tidy: guarded-by=_registry_lock
# Device-plane ledgers. _device_mem: owner tag -> live device bytes.
# _device_inflight: entry -> its open windows, oldest first (a dict used
# as an ordered set), bounded per entry.
# _device_pairs: the last closed windows (entry, t0_ns, t1_ns, h2d bytes,
# d2h bytes) for the trace's device lane.
_device_mem: Dict[str, int] = {}  # tidy: guarded-by=_registry_lock
_device_mem_hw = [0]  # tidy: guarded-by=_registry_lock
_device_inflight: Dict[str, dict] = {}  # tidy: guarded-by=_registry_lock
_DEVICE_INFLIGHT_MAX = 64  # per entry; beyond = abandoned windows
_device_pairs: deque = deque(maxlen=4096)  # tidy: guarded-by=_registry_lock
# Entry names admitted at run time (register_device_entry).
_device_entries_extra: set = set()  # tidy: guarded-by=_registry_lock
_tls = threading.local()


class _ThreadState:
    """One thread's private recording arena: aggregate table, histograms,
    counters, span-object pool, and the bounded span ring (parallel
    preallocated arrays: no allocation per record)."""

    __slots__ = (
        "gen", "thread", "tid", "name", "agg", "hist", "counters", "pool",
        "ring_event", "ring_t0", "ring_t1", "ring_n", "ring_mask",
    )

    def __init__(self, gen: int, ring_size: int) -> None:
        t = threading.current_thread()
        self.gen = gen
        self.thread = t
        self.tid = t.ident or 0
        self.name = t.name
        self.agg: Dict[str, list] = {}  # event -> [count, total_ns, max_ns]
        self.hist: Dict[str, array] = {}
        self.counters: Dict[str, int] = {}
        self.pool: List[_Span] = []
        self.ring_mask = ring_size - 1
        self.ring_event: List[Optional[str]] = [None] * ring_size
        self.ring_t0 = array("q", bytes(8 * ring_size))
        self.ring_t1 = array("q", bytes(8 * ring_size))
        self.ring_n = 0

    def record(self, event: str, t0: int, t1: int) -> None:
        dt = t1 - t0
        agg = self.agg.get(event)
        if agg is None:
            agg = self.agg[event] = [0, 0, 0]
            self.hist[event] = array("q", _HIST_ZEROS)
        agg[0] += 1
        agg[1] += dt
        if dt > agg[2]:
            agg[2] = dt
        self.hist[event][bucket_index(dt if dt > 0 else 0)] += 1
        i = self.ring_n & self.ring_mask
        self.ring_event[i] = event
        self.ring_t0[i] = t0
        self.ring_t1[i] = t1
        self.ring_n += 1


def _state() -> _ThreadState:
    st = getattr(_tls, "state", None)
    while st is None or st.gen != _generation:
        st = _ThreadState(_generation, _ring_size)
        with _registry_lock:
            # Registration is atomic with the generation check: a reset()
            # that raced the arena's creation already cleared the
            # registry, and registering the stale arena would leak it
            # (and its records) into every later snapshot. Rebuild
            # against the new generation instead.
            if st.gen == _generation:
                _fold_dead_locked()
                # One lane a thread: a new thread that reuses a dead
                # one's ident gets a lane id of its own.
                taken = {other.tid for other in _states}
                if st.tid in taken:
                    st.tid = max(taken) + 1
                _states.append(st)
                _tls.state = st
                break
        st = None
    return st


def _merge_tables(into: list, agg_items, hist_items, counter_items) -> None:
    """Add one arena's (agg, hist, counters) items into `into`'s tables."""
    agg, hists, counters = into
    for event, (n, total, mx) in agg_items:
        rec = agg.get(event)
        if rec is None:
            agg[event] = [n, total, mx]
        else:
            rec[0] += n
            rec[1] += total
            if mx > rec[2]:
                rec[2] = mx
    for event, h in hist_items:
        merged = hists.get(event)
        if merged is None:
            hists[event] = list(h)
        else:
            for i, v in enumerate(h):
                if v:
                    merged[i] += v
    for event, n in counter_items:
        counters[event] = counters.get(event, 0) + n


def _fold_dead_locked() -> None:  # tidy: holds=_registry_lock
    """Fold the oldest dead threads' arenas into the retired table once
    more than DEAD_ARENAS_MAX are registered, dropping their rings. A
    dead thread writes nothing more, so its tables are read whole."""
    dead = [st for st in _states if not st.thread.is_alive()]
    if len(dead) <= DEAD_ARENAS_MAX:
        return
    for st in dead[: len(dead) - DEAD_ARENAS_MAX]:
        _merge_tables(_retired, st.agg.items(), st.hist.items(), st.counters.items())
        _states.remove(st)


class _Span:
    """Reusable timed-region context manager (pooled per thread)."""

    __slots__ = ("state", "event", "t0")

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        state = self.state
        state.record(self.event, self.t0, time.perf_counter_ns())
        if len(state.pool) < 64:
            state.pool.append(self)
        return False


class _NullSpan:
    """Singleton no-op span: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SPAN = _NullSpan()


def null_span() -> _NullSpan:
    """The shared no-op span, for callers that decide span identity
    themselves."""
    return _NULL_SPAN


# --- control ----------------------------------------------------------------


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Discard every thread's recorded data, the gauges, the device
    ledgers and the lifecycle state. Threads re-create their arena
    lazily (generation bump), so no cross-thread mutation races an active
    writer; a span straddling the reset lands in its old, now
    unregistered arena and is dropped."""
    global _generation
    with _registry_lock:
        _generation += 1
        _states.clear()
        for table in _retired:
            table.clear()
        _gauges.clear()
        _device_mem.clear()
        _device_mem_hw[0] = 0
        _device_inflight.clear()
        _device_pairs.clear()
        # The lifecycle re-arms with the spans: ring, pool, running
        # perceived histogram, summary window and the dump budget.
        _op_ring.clear()
        _op_pool.clear()
        _op_hist[:] = array("q", _HIST_ZEROS)
        _op_window[:] = [0, 0, 0]
        _flight.update(dumps=0, exception_dumps=0, last_dump_ns=0)
        _flight_docs.clear()


def configure(ring_size: Optional[int] = None) -> None:
    """Set the per-thread span-ring capacity (rounded up to a power of
    two). Implies reset(): existing rings are discarded."""
    global _ring_size
    if ring_size is not None:
        n = 1
        while n < ring_size:
            n <<= 1
        _ring_size = n
    reset()


# --- recording ----------------------------------------------------------------


def span(event: str):
    """Time a scoped region under `event`. Enabled: two perf_counter_ns
    calls and one pooled object; disabled: one flag check."""
    if not _enabled:
        return _NULL_SPAN
    st = _state()
    pool = st.pool
    s = pool.pop() if pool else _Span()
    s.state = st
    s.event = event
    return s


def observe(event: str, duration_ns: int) -> None:
    """Record a duration measured by the caller, ending now: the same
    aggregate, histogram and ring as a span."""
    if not _enabled:
        return
    t1 = time.perf_counter_ns()
    _state().record(event, t1 - duration_ns, t1)


def count(event: str, n: int = 1) -> None:
    """Bump a counter without timing, in the calling thread's arena."""
    if not _enabled:
        return
    st = _state()
    st.counters[event] = st.counters.get(event, 0) + n


def gauge(name: str, value: float) -> None:
    """Set a last-write-wins gauge (queue depths, table counts)."""
    if not _enabled:
        return
    with _registry_lock:
        _gauges[name] = value


def remove_gauge(name: str) -> None:
    """Retire a gauge whose identity died: per-instance gauge families
    must not grow without bound."""
    if not _enabled:
        return
    with _registry_lock:
        _gauges.pop(name, None)


def remove_gauges_prefix(prefix: str) -> None:
    """Retire every gauge under a name prefix (a peer's `vsr.peer.<r>.*`
    family when it goes away)."""
    if not _enabled:
        return
    with _registry_lock:
        for name in [n for n in _gauges if n.startswith(prefix)]:
            del _gauges[name]


def gauges() -> Dict[str, float]:
    with _registry_lock:
        return dict(_gauges)


# --- device memory ledger -------------------------------------------------------


def device_mem_totals() -> dict:
    """Ledger snapshot: per-owner live bytes, the live total and the
    process high-water total."""
    with _registry_lock:
        owners = dict(_device_mem)
        hw = _device_mem_hw[0]
    return {"owners": owners, "total_bytes": sum(owners.values()), "high_water_bytes": hw}


def device_inflight() -> dict:
    """Open dispatch windows: per-entry count and the total depth."""
    with _registry_lock:
        per = {e: len(wins) for e, wins in _device_inflight.items() if wins}
    return {"entries": per, "window_depth": sum(per.values())}


def device_mem_set(owner: str, nbytes: int) -> None:
    """Set an owner's live device bytes (absolute)."""
    if not _enabled:
        return
    with _registry_lock:
        _device_mem[owner] = int(nbytes)
        _gauges[f"device.mem.{owner}.bytes"] = float(nbytes)
        _device_mem_hw[0] = max(_device_mem_hw[0], sum(_device_mem.values()))


def device_mem_adjust(owner: str, delta: int) -> None:
    """Adjust an owner's live device bytes by a delta (clamped at 0: a
    release racing a reset must not publish negative residency)."""
    if not _enabled:
        return
    with _registry_lock:
        v = max(0, _device_mem.get(owner, 0) + int(delta))
        _device_mem[owner] = v
        _gauges[f"device.mem.{owner}.bytes"] = float(v)
        _device_mem_hw[0] = max(_device_mem_hw[0], sum(_device_mem.values()))


def device_mem_release(owner: str) -> None:
    """Drop an owner whose device allocation died, gauge included (the
    high-water total stays)."""
    if not _enabled:
        return
    with _registry_lock:
        _device_mem.pop(owner, None)
        _gauges.pop(f"device.mem.{owner}.bytes", None)


def device_mem_retire_prefix(prefix: str) -> None:
    """Retire every ledger owner (and gauge) under a tag prefix."""
    if not _enabled:
        return
    with _registry_lock:
        for owner in [o for o in _device_mem if o.startswith(prefix)]:
            del _device_mem[owner]
        gp = f"device.mem.{prefix}"
        for name in [n for n in _gauges if n.startswith(gp)]:
            del _gauges[name]


# --- device-step profiler ---------------------------------------------------------
#
# Per-entry device time and transfer byte counters, keyed by the kernel
# entries of tidy/manifest.KERNEL_ENTRIES: an entry name this module has
# never heard of raises, so every kernel's numbers stay attributable to a
# declared entry.


def register_device_entry(name: str) -> None:
    """Admit an entry built at run time to the device-step namespace."""
    with _registry_lock:
        _device_entries_extra.add(name)


def _device_entry_check(entry: str) -> None:
    base = entry[len(manifest.MESH_ENTRY_PREFIX):] if entry.startswith(
        manifest.MESH_ENTRY_PREFIX) else entry
    if base in manifest.KERNEL_ENTRIES:
        return
    with _registry_lock:
        known = entry in _device_entries_extra
    if not known:
        raise ValueError(
            f"unknown device entry {entry!r}: add it to "
            "tidy/manifest.KERNEL_ENTRIES (or register_device_entry) so its "
            "kernel numbers stay attributable"
        )


def device_step(entry: str):
    """Span over a BLOCKING kernel entry (call + materialization):
    `device.<entry>`."""
    if not _enabled:
        return _NULL_SPAN
    _device_entry_check(entry)
    return span(f"device.{entry}")


class _Window:
    __slots__ = ("t0", "event", "h2d_bytes")

    def __init__(self, t0: int, event, h2d_bytes: int = 0) -> None:
        self.t0 = t0
        self.event = event
        self.h2d_bytes = h2d_bytes


def _cuda_event():
    """A timing event recorded on the current CUDA stream, or None when
    CUDA was never initialised in this process."""
    import torch

    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def device_dispatch(entry: str, h2d_bytes: int = 0):
    """Open a dispatch window; returns the token for device_finish (0
    when disabled). Counts the host-to-device bytes staged for the call;
    the window stays open until its finish (at most _DEVICE_INFLIGHT_MAX
    an entry: the oldest abandoned one is evicted)."""
    if not _enabled:
        return 0
    _device_entry_check(entry)
    count(f"device.{entry}.dispatches")
    if h2d_bytes:
        count("device.h2d_bytes", h2d_bytes)
    token = _Window(time.perf_counter_ns(), _cuda_event(), h2d_bytes)
    with _registry_lock:
        wins = _device_inflight.setdefault(entry, {})
        wins[token] = None
        while len(wins) > _DEVICE_INFLIGHT_MAX:
            del wins[next(iter(wins))]
    return token


def device_finish(entry: str, token, d2h_bytes: int = 0) -> None:
    """Close a dispatch window: `device.step.<entry>` gets the device
    time between the dispatch and this call (host time off CUDA). Called
    only at the sanctioned sync seams, so the transfer-bandwidth stamps
    add no sync of their own: `device.xfer.{h2d,d2h}.gbps` hold RAW
    values in MB/s (GB/s × 1000, so snapshot()'s `p50_us` field reads
    directly as GB/s) over the window's time."""
    if not _enabled or not token:
        return
    with _registry_lock:
        wins = _device_inflight.get(entry)
        if wins:
            wins.pop(token, None)
    if d2h_bytes:
        count("device.d2h_bytes", d2h_bytes)
    if token.event is not None:
        end = _cuda_event()
        end.synchronize()
        dur = int(token.event.elapsed_time(end) * 1e6)
    else:
        dur = time.perf_counter_ns() - token.t0
    observe(f"device.step.{entry}", dur)
    if dur > 0:
        if token.h2d_bytes:
            observe("device.xfer.h2d.gbps", max(1, token.h2d_bytes * 1000 // dur))
        if d2h_bytes:
            observe("device.xfer.d2h.gbps", max(1, d2h_bytes * 1000 // dur))
    with _registry_lock:
        _device_pairs.append((entry, token.t0, time.perf_counter_ns(),
                              token.h2d_bytes, d2h_bytes))


def device_bytes(h2d: int = 0, d2h: int = 0) -> None:
    """Count transfer bytes for a blocking entry (device_step path)."""
    if not _enabled:
        return
    if h2d:
        count("device.h2d_bytes", h2d)
    if d2h:
        count("device.d2h_bytes", d2h)


# --- merge / snapshot ---------------------------------------------------------------


def _merged() -> Tuple[Dict[str, list], Dict[str, list], Dict[str, int]]:
    """(agg, hists, counters) merged across every registered arena and
    the retired table, in registration order. Reads race active writers
    benignly: a concurrent insert can make one retry; totals are exact
    once writers quiesce."""
    out = [{}, {}, {}]
    with _registry_lock:
        states = list(_states)
        _merge_tables(out, _retired[0].items(), _retired[1].items(), _retired[2].items())
    for st in states:
        for attempt in range(4):
            try:
                a_items = list(st.agg.items())
                h_items = list(st.hist.items())
                c_items = list(st.counters.items())
                break
            except RuntimeError:  # dict resized mid-iteration
                if attempt == 3:
                    a_items, h_items, c_items = [], [], []
        _merge_tables(out, a_items, h_items, c_items)
    return out[0], out[1], out[2]


def snapshot() -> Dict[str, dict]:
    """event → {count, total_ms, avg_us, max_us, p50_us, p95_us, p99_us}
    for spans; counters appear with total_ms 0 and no percentiles.
    Merged deterministically across every thread that recorded."""
    agg, hists, counters = _merged()
    out: Dict[str, dict] = {}
    for event in sorted(agg):
        n, total, mx = agg[event]
        rec = {
            "count": n,
            "total_ms": round(total / 1e6, 3),
            "avg_us": round(total / n / 1e3, 1) if n else 0.0,
            "max_us": round(mx / 1e3, 1),
        }
        h = hists.get(event)
        if h is not None:
            hn = sum(h)
            rec["p50_us"] = round(_hist_percentile(h, hn, 0.50) / 1e3, 1)
            rec["p95_us"] = round(_hist_percentile(h, hn, 0.95) / 1e3, 1)
            rec["p99_us"] = round(_hist_percentile(h, hn, 0.99) / 1e3, 1)
        out[event] = rec
    for event in sorted(counters):
        rec = out.get(event)
        if rec is None:
            out[event] = {"count": counters[event], "total_ms": 0.0,
                          "avg_us": 0.0, "max_us": 0.0}
        else:
            rec["count"] += counters[event]
    return out


# --- per-operation lifecycle ------------------------------------------------
#
# One pooled OpRecord per prepare, stamped at every pipeline hand-off. The
# stamps are plain perf_counter_ns writes into a preallocated array slot;
# each stamp index is written by exactly one thread at a known hand-off,
# and the record travels WITH the op (message attribute / job dict), so
# stamp writes are ordered by the same queue hand-offs that order the op.
# op_finish (loop thread) observes the derived components into the span
# registry and files the record in the flight ring.

(
    OP_ARRIVE, OP_PREPARE, OP_WAL_ENQUEUE, OP_WAL_WRITE, OP_WAL_DURABLE,
    OP_COMMIT_SUBMIT, OP_EXEC_START, OP_EXEC_END, OP_REPLY,
    OP_STORE_SUBMIT, OP_STORE_START, OP_STORE_END,
) = range(12)
OP_STAMPS = 12
OP_STAMP_NAMES = (
    "arrive", "prepare", "wal_enqueue", "wal_write", "wal_durable",
    "commit_submit", "exec_start", "exec_end", "reply",
    "store_submit", "store_start", "store_end",
)

# (event, from-stamp, to-stamp): the arrive -> reply window. The window
# components tile [ARRIVE, REPLY] exactly.
OP_COMPONENTS = (
    ("op.queue.request", OP_ARRIVE, OP_PREPARE),
    ("op.service.prepare", OP_PREPARE, OP_WAL_ENQUEUE),
    ("op.queue.wal", OP_WAL_ENQUEUE, OP_WAL_WRITE),
    ("op.service.wal", OP_WAL_WRITE, OP_WAL_DURABLE),
    ("op.queue.quorum", OP_WAL_DURABLE, OP_COMMIT_SUBMIT),
    ("op.queue.commit", OP_COMMIT_SUBMIT, OP_EXEC_START),
    ("op.service.execute", OP_EXEC_START, OP_EXEC_END),
    ("op.service.reply", OP_EXEC_END, OP_REPLY),
)
# Store components trail the reply; excluded from the perceived window.
OP_STORE_COMPONENTS = (
    ("op.queue.store", OP_STORE_SUBMIT, OP_STORE_START),
    ("op.service.store", OP_STORE_START, OP_STORE_END),
)
_OP_ZEROS = bytes(8 * OP_STAMPS)

# Per-peer prepare_ok arrival stamps (vsr/peerstats.py, primary only):
# slot index = acking replica index.
OP_PEER_MAX = 8
_PEER_ZEROS = bytes(8 * OP_PEER_MAX)


class OpRecord:
    """One prepare's lifecycle: identity + stamp array. Pooled: reset()
    zeroes in place, no per-op allocation at steady state."""

    __slots__ = (
        "op", "client", "request", "operation", "n_events", "t", "done",
        "released", "peer_t", "peer_bcast", "quorum_t", "quorum_peer",
        "peers_open", "ring_evicted",
    )

    def __init__(self) -> None:
        self.t = array("q", _OP_ZEROS)
        self.peer_t = array("q", _PEER_ZEROS)
        self.reset()

    def reset(self) -> None:
        self.op = 0
        self.client = 0
        self.request = 0
        self.operation = 0
        self.n_events = 0
        self.done = False
        # Set by op_store_done: no thread holds the record any longer, so
        # an eviction may recycle it.
        self.released = False
        # Cluster-plane stamps (primary only): broadcast time, the q-th
        # prepare_ok that completed the quorum and its peer. peers_open:
        # the straggler tracker still holds the record.
        self.peer_bcast = 0
        self.quorum_t = 0
        self.quorum_peer = -1
        self.peers_open = False
        # Evicted from the ring while its peer window was open:
        # op_peer_release re-offers it to the pool.
        self.ring_evicted = False
        t = self.t
        for i in range(OP_STAMPS):
            t[i] = 0
        pt = self.peer_t
        for i in range(OP_PEER_MAX):
            pt[i] = 0


OP_RING_DEFAULT = 128  # completed records retained for the flight dump

_op_ring_size = OP_RING_DEFAULT
_op_ring: deque = deque()  # tidy: guarded-by=_registry_lock
_op_pool: List[OpRecord] = []  # tidy: guarded-by=_registry_lock
# Running histogram of the perceived latency (arrive -> reply): the
# anomaly rule's running p99 and the admission control's source.
_op_hist = array("q", _HIST_ZEROS)  # tidy: guarded-by=_registry_lock
# [first_finalize_ns, last_finalize_ns, perceived_count]
_op_window = [0, 0, 0]  # tidy: guarded-by=_registry_lock

# Flight-recorder policy. latency_mult: trip when the perceived latency
# exceeds mult x the running p99; stall_ns: trip when one component
# exceeds it; min_ops: samples before the latency rule arms. Dumps are
# kept in memory (flight_dumps()) and, when `dir` is set, written there.
_flight = {  # tidy: guarded-by=_registry_lock
    "latency_mult": 8.0,
    "stall_ns": 2_000_000_000,
    "min_ops": 64,
    "max_dumps": 3,
    "cooldown_ns": 5_000_000_000,
    "dumps": 0,
    # Pipeline-exception trips, counted even when the dump was rate
    # limited: "did an exception happen" is answerable on its own.
    "exception_dumps": 0,
    "last_dump_ns": 0,
    "dir": "",
}
_flight_docs: List[dict] = []  # tidy: guarded-by=_registry_lock


def op_begin() -> Optional[OpRecord]:
    """Claim a pooled lifecycle record (None when tracing is disabled;
    every op_* accessor accepts None and returns at once)."""
    if not _enabled:
        return None
    with _registry_lock:
        rec = _op_pool.pop() if _op_pool else None
    if rec is None:
        return OpRecord()
    rec.reset()
    return rec


def op_stamp(rec: Optional[OpRecord], idx: int, t_ns: Optional[int] = None) -> None:
    """Record one hand-off stamp (now, or an injected t_ns). Overwrites:
    a requeued op re-stamps."""
    if rec is None:
        return
    rec.t[idx] = time.perf_counter_ns() if t_ns is None else t_ns


def op_stamp_first(rec: Optional[OpRecord], idx: int) -> None:
    """Stamp only if unset (the split-phase path marks exec-start at
    dispatch; the settle path must not overwrite it)."""
    if rec is None or rec.t[idx]:
        return
    rec.t[idx] = time.perf_counter_ns()


def op_clear(rec: Optional[OpRecord], *indices: int) -> None:
    """Unset stamps on a requeued op, so the retry re-stamps."""
    if rec is None:
        return
    for i in indices:
        rec.t[i] = 0


def op_meta(rec: Optional[OpRecord], op: int = 0, client: int = 0,
            request: int = 0, operation: int = 0, n_events: int = 0) -> None:
    if rec is None:
        return
    rec.op = op
    rec.client = client
    rec.request = request
    rec.operation = operation
    rec.n_events = n_events


def _op_components(rec: OpRecord, table) -> List[tuple]:
    """[(event, duration_ns)] for components whose both stamps landed;
    negative spans (cross-thread skew) clamp to 0."""
    t = rec.t
    out = []
    for event, a, b in table:
        ta, tb = t[a], t[b]
        if ta and tb:
            out.append((event, tb - ta if tb > ta else 0))
    return out


def op_finish(rec: Optional[OpRecord]) -> None:
    """Finalize the arrive -> reply window: observe every component and
    the totals, file the record in the flight ring, run the anomaly
    checks. Loop thread, once per op (idempotent via rec.done)."""
    if rec is None or rec.done:
        return
    rec.done = True
    comps = _op_components(rec, OP_COMPONENTS)
    queue_total = 0
    service_total = 0
    worst = ("", 0)
    for event, d in comps:
        observe(event, d)
        if ".queue." in event:
            queue_total += d
        else:
            service_total += d
        if d > worst[1]:
            worst = (event, d)
    t = rec.t
    perceived = t[OP_REPLY] - t[OP_ARRIVE] if t[OP_REPLY] and t[OP_ARRIVE] else 0
    if perceived > 0:
        # Totals only for full arrive -> reply records (a backup's
        # journal-path commit has execute and store stamps only).
        observe("op.queue.total", queue_total)
        observe("op.service.total", service_total)
    trip = None
    with _registry_lock:
        now = time.perf_counter_ns()
        if not _op_window[0]:
            _op_window[0] = now
        _op_window[1] = now
        if len(_op_ring) >= _op_ring_size:
            evicted = _op_ring.popleft()
            # Recycle only records no thread can still stamp: released
            # (op_store_done ran), no open peer window, WAL complete.
            et = evicted.t
            if (
                evicted.released
                and not evicted.peers_open
                and (not et[OP_WAL_ENQUEUE] or et[OP_WAL_DURABLE])
            ):
                _op_pool.append(evicted)
            else:
                evicted.ring_evicted = True
        _op_ring.append(rec)
        if perceived > 0:
            if _op_window[2] >= _flight["min_ops"]:
                p99 = _hist_percentile(_op_hist, _op_window[2], 0.99)
                if p99 > 0 and perceived > _flight["latency_mult"] * p99:
                    trip = (
                        f"latency: perceived {perceived / 1e6:.1f} ms > "
                        f"{_flight['latency_mult']:g}x running p99 "
                        f"{p99 / 1e6:.1f} ms (op {rec.op})"
                    )
            _op_hist[bucket_index(perceived)] += 1
            _op_window[2] += 1
        if trip is None and worst[1] > _flight["stall_ns"]:
            trip = (
                f"stall: {worst[0]} {worst[1] / 1e6:.1f} ms > "
                f"{_flight['stall_ns'] / 1e6:.0f} ms threshold (op {rec.op})"
            )
    if perceived > 0:
        observe("op.perceived", perceived)
    if trip is not None:
        flight_trip(trip)


def op_store_done(rec: Optional[OpRecord]) -> None:
    """Observe the trailing store components (store thread) and run the
    stall check on them; the record's last touch."""
    if rec is None:
        return
    worst = ("", 0)
    for event, d in _op_components(rec, OP_STORE_COMPONENTS):
        observe(event, d)
        if d > worst[1]:
            worst = (event, d)
    with _registry_lock:
        stall_ns = _flight["stall_ns"]
    if worst[1] > stall_ns:
        flight_trip(
            f"stall: {worst[0]} {worst[1] / 1e6:.1f} ms > "
            f"{stall_ns / 1e6:.0f} ms threshold (op {rec.op})"
        )
    rec.released = True


def op_peer_release(rec: Optional[OpRecord]) -> None:
    """The peer tracker let go of a record: pool it now if the ring
    already evicted it and every other holder is done."""
    if rec is None:
        return
    rec.peers_open = False
    if not rec.ring_evicted:
        return
    t = rec.t
    if rec.released and (not t[OP_WAL_ENQUEUE] or t[OP_WAL_DURABLE]):
        rec.ring_evicted = False
        with _registry_lock:
            _op_pool.append(rec)


def op_record_dict(rec: OpRecord) -> dict:
    """JSON-ready view of one lifecycle record. Its raw stamps share the
    perf_counter timebase with trace_events(), so a flight dump and its
    trace align op for op."""
    t = rec.t
    out = {
        "op": rec.op, "client": rec.client, "request": rec.request,
        "operation": rec.operation, "n_events": rec.n_events,
        "stamps": {OP_STAMP_NAMES[i]: t[i] for i in range(OP_STAMPS) if t[i]},
        "components": {
            e: round(d / 1e6, 3)
            for e, d in _op_components(rec, OP_COMPONENTS + OP_STORE_COMPONENTS)
        },
    }
    if t[OP_REPLY] and t[OP_ARRIVE]:
        out["perceived_ms"] = round((t[OP_REPLY] - t[OP_ARRIVE]) / 1e6, 3)
    if rec.peer_bcast:
        # The primary's cluster-plane stamps: each peer's prepare_ok after
        # the broadcast, and the quorum point (trace_summary --ops renders
        # them under the quorum wait).
        oks = {
            str(r): round((rec.peer_t[r] - rec.peer_bcast) / 1e6, 3)
            for r in range(OP_PEER_MAX) if rec.peer_t[r]
        }
        if oks:
            out["peer_ok_ms"] = oks
        if rec.quorum_t:
            out["quorum_ms"] = round((rec.quorum_t - rec.peer_bcast) / 1e6, 3)
            if rec.quorum_peer >= 0:
                out["quorum_peer"] = rec.quorum_peer
    return out


def flight_records() -> List[dict]:
    """The completed-op ring as JSON-ready dicts (newest last), serialized
    under the lock: an eviction may recycle a record concurrently, and a
    dict mixing two ops would corrupt the artifact the ring exists for."""
    with _registry_lock:
        return [op_record_dict(r) for r in _op_ring]


def configure_flight(
    latency_mult: Optional[float] = None,
    stall_ms: Optional[float] = None,
    min_ops: Optional[int] = None,
    max_dumps: Optional[int] = None,
    cooldown_s: Optional[float] = None,
    directory: Optional[str] = None,
    ring: Optional[int] = None,
) -> None:
    """Adjust the flight recorder's policy; `directory` also writes each
    dump there; `ring` resizes (and clears) the completed-op ring."""
    global _op_ring_size
    with _registry_lock:
        if latency_mult is not None:
            _flight["latency_mult"] = float(latency_mult)
        if stall_ms is not None:
            _flight["stall_ns"] = int(stall_ms * 1e6)
        if min_ops is not None:
            _flight["min_ops"] = int(min_ops)
        if max_dumps is not None:
            _flight["max_dumps"] = int(max_dumps)
        if cooldown_s is not None:
            _flight["cooldown_ns"] = int(cooldown_s * 1e9)
        if directory is not None:
            _flight["dir"] = directory
        if ring is not None:
            _op_ring_size = max(1, int(ring))
            _op_ring.clear()
            _op_pool.clear()


def perceived_p99_ms(state: Optional[dict] = None) -> Optional[float]:
    """Perceived (arrive -> reply) p99 in ms from the running histogram.
    With `state` (a caller-held dict, mutated in place) the percentile
    covers only ops finalized since the previous call with that dict; an
    empty window returns None ("no evidence": the caller holds its
    previous decision)."""
    with _registry_lock:
        cur = list(_op_hist)
        total = _op_window[2]
    if state is None:
        return _hist_percentile(cur, total, 0.99) / 1e6 if total else 0.0
    prev, prev_total = state.get("hist"), state.get("total", 0)
    state["hist"] = cur
    state["total"] = total
    if prev is None or total <= prev_total:
        return None
    delta = [c - p for c, p in zip(cur, prev)]
    return _hist_percentile(delta, total - prev_total, 0.99) / 1e6


def flight_trip(reason: str) -> Optional[str]:
    """Record a flight dump: the completed-op ring, the open device
    windows and the device memory ledger at the trip, kept in memory
    (flight_dumps()) and, when configure_flight named a directory, written
    there with the span rings as a trace beside it. Rate limited:
    max_dumps a process, and a cooldown between two. Returns the dump's
    path (None when kept in memory only, or suppressed)."""
    if not _enabled:
        return None
    with _registry_lock:
        now = time.perf_counter_ns()
        if _flight["dumps"] >= _flight["max_dumps"]:
            return None
        if now - _flight["last_dump_ns"] < _flight["cooldown_ns"] and _flight["dumps"]:
            return None
        _flight["dumps"] += 1
        _flight["last_dump_ns"] = now
        inflight = {e: len(wins) for e, wins in _device_inflight.items() if wins}
        doc = {
            "reason": reason,
            "tripped_ns": now,
            "ops": [op_record_dict(r) for r in _op_ring],
            "device": {
                "inflight": inflight,
                "window_depth": sum(inflight.values()),
                "mem": dict(_device_mem),
                "mem_total_bytes": sum(_device_mem.values()),
                "mem_high_water_bytes": _device_mem_hw[0],
            },
        }
        _flight_docs.append(doc)
        directory, seq = _flight["dir"], _flight["dumps"]
    count("mark.flight_dump")
    if not directory:
        return None
    base = os.path.join(directory, f"tbtorch_flight_{os.getpid()}_{seq}")
    try:
        with open(base + ".json", "w") as f:
            json.dump(doc, f)
        dump(base + "_trace.json")
    except OSError:
        return None  # a read-only disk must not take the pipeline down
    return base + ".json"


def flight_exception(reason: str) -> Optional[str]:
    """Pipeline-exception trip (stage poison, fail-stop dispatch): dump
    whatever the latency rules say, and count it apart from anomaly
    trips, even when the dump itself was rate limited."""
    with _registry_lock:
        _flight["exception_dumps"] += 1
    return flight_trip(f"exception: {reason}")


def flight_exceptions() -> int:
    """Pipeline-exception trips so far in this process."""
    with _registry_lock:
        return _flight["exception_dumps"]


def flight_dumps() -> List[dict]:
    """The flight dumps recorded so far, oldest first."""
    with _registry_lock:
        return list(_flight_docs)


# --- the scrape surface -----------------------------------------------------

_OCCUPANCY_STAGES = {  # tidy: atomic — immutable constant table, never written after import
    "wal": ("op.queue.wal", "op.service.wal"),
    "execute": ("op.queue.commit", "op.service.execute"),
    "store": ("op.queue.store", "op.service.store"),
    "total": ("op.perceived",),
}


def _op_window_ns() -> int:
    with _registry_lock:
        return max(0, _op_window[1] - _op_window[0])


def _stage_occupancy(total_ms_of, window_ns: int) -> Dict[str, float]:
    """Little's-law occupancy (mean prepares resident a stage) from each
    event's total milliseconds over the summary window."""
    if window_ns <= 0:
        return {}
    return {
        stage: round(sum(total_ms_of(e) for e in events) * 1e6 / window_ns, 3)
        for stage, events in _OCCUPANCY_STAGES.items()
    }


def lifecycle_summary() -> dict:
    """The per-op decomposition: per-component count / mean / p50 / p99
    (ms), the perceived window, Little's-law occupancy and the flight
    recorder's status. `flat` holds the benchmark-facing keys
    (queue_wait_* / service_* / occupancy_* and the store, query,
    replication and commit-window rows)."""
    agg, hists, _ = _merged()
    with _registry_lock:
        first, last, _n = _op_window
        flight = {
            "dumps": _flight["dumps"],
            "exception_dumps": _flight["exception_dumps"],
            "ring": len(_op_ring),
            "latency_mult": _flight["latency_mult"],
            "stall_ms": round(_flight["stall_ns"] / 1e6, 1),
        }
        depth_cfg = _gauges.get("pipeline.commit.depth_config")
        device_hw = _device_mem_hw[0]
    window_ns = max(0, last - first)
    components: Dict[str, dict] = {}
    flat: Dict[str, float] = {}
    occupancy: Dict[str, float] = {}

    def stats(event):
        rec = agg.get(event)
        if rec is None:
            return None
        n, total, _mx = rec
        h = hists.get(event)
        hn = sum(h) if h else 0
        return {
            "count": n,
            "mean_ms": round(total / n / 1e6, 4) if n else 0.0,
            "total_ms": round(total / 1e6, 3),
            "p50_ms": round(_hist_percentile(h, hn, 0.50) / 1e6, 4) if h else 0.0,
            "p99_ms": round(_hist_percentile(h, hn, 0.99) / 1e6, 4) if h else 0.0,
        }

    for event, _a, _b in OP_COMPONENTS + OP_STORE_COMPONENTS:
        s = stats(event)
        if s is None:
            continue
        short = event[len("op."):]
        components[short] = s
        key = short.replace("queue.", "queue_wait_").replace("service.", "service_")
        flat[f"{key}_ms"] = s["mean_ms"]
        flat[f"{key}_p50_ms"] = s["p50_ms"]
        flat[f"{key}_p99_ms"] = s["p99_ms"]
        if window_ns > 0:
            occupancy[short] = round(s["total_ms"] * 1e6 / window_ns, 3)
    for event, key in (
        ("op.queue.total", "queue_wait_total"),
        ("op.service.total", "service_total"),
        ("op.perceived", "lifecycle_perceived"),
        ("vsr.replication.lag", "replication_lag"),
        ("vsr.quorum.straggler", "quorum_straggler"),
    ):
        s = stats(event)
        if s is None:
            continue
        flat[f"{key}_ms"] = s["mean_ms"]
        flat[f"{key}_p50_ms"] = s["p50_ms"]
        flat[f"{key}_p99_ms"] = s["p99_ms"]
    for event, key in (
        ("sm.store.query", "store_query_ms_per_batch"),
        ("pipeline.store.stall", "store_stall_ms_per_wait"),
    ):
        s = stats(event)
        if s is None:
            continue
        flat[key] = s["mean_ms"]
        flat[f"{key}_p50"] = s["p50_ms"]
        flat[f"{key}_p99"] = s["p99_ms"]
    s = stats("sm.query")
    if s is not None:
        flat["query_ms"] = s["mean_ms"]
        flat["query_p50_ms"] = s["p50_ms"]
        flat["query_p99_ms"] = s["p99_ms"]
    inflight = agg.get("pipeline.commit.inflight_depth")
    if inflight is not None and inflight[0]:
        n_if, total_if, max_if = inflight
        flat["commit_inflight_mean"] = round(total_if / n_if, 3)
        flat["commit_inflight_max"] = int(max_if)
        h_if = hists.get("pipeline.commit.inflight_depth")
        if h_if:
            flat["commit_inflight_p99"] = float(_hist_percentile(h_if, sum(h_if), 0.99))
    if depth_cfg is not None:
        flat["commit_depth"] = float(depth_cfg)
    if device_hw > 0:
        flat["device_mem_high_water_bytes"] = float(device_hw)
    occupancy.update(_stage_occupancy(
        lambda e: agg[e][1] / 1e6 if e in agg else 0.0, window_ns
    ))
    for k in ("wal", "execute", "store", "total"):
        if k in occupancy:
            flat[f"occupancy_{k}"] = occupancy[k]
    perceived = stats("op.perceived") or {"count": 0}
    return {
        "ops": perceived["count"],
        "window_s": round(window_ns / 1e9, 3),
        "components": components,
        "perceived": perceived,
        "occupancy": occupancy,
        "flight": flight,
        "flat": flat,
    }


def emit_json() -> str:
    return json.dumps(snapshot())


def trace_events() -> List[tuple]:
    """[(event, thread_name, tid, t0_ns, t1_ns)] merged across the
    threads' rings, sorted by start time (ties in registration order).
    Each thread contributes at most its ring's capacity, its newest
    records."""
    out: List[tuple] = []
    with _registry_lock:
        states = list(_states)
    for st in states:
        n = st.ring_n
        size = st.ring_mask + 1
        for j in range(max(0, n - size), n):
            i = j & st.ring_mask
            ev = st.ring_event[i]
            if ev is not None:
                out.append((ev, st.name, st.tid, st.ring_t0[i], st.ring_t1[i]))
    out.sort(key=lambda r: r[3])
    return out


def export_trace() -> dict:
    """Chrome trace-event JSON (ui.perfetto.dev, chrome://tracing): one
    complete event ('X') per span record on its thread's lane, named by
    thread-name metadata, one async pair ('b' / 'e') per closed device
    window, and a timebase anchor pairing the process-local perf_counter
    with the wall clock so traces of separate replica processes can be
    merged."""
    pid = os.getpid()
    evs: List[dict] = []
    named: set = set()
    for event, name, tid, t0, t1 in trace_events():
        if tid not in named:
            named.add(tid)
            evs.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                        "args": {"name": name}})
        evs.append({"name": event, "cat": "tbtpu", "ph": "X", "pid": pid,
                    "tid": tid, "ts": t0 / 1e3, "dur": (t1 - t0) / 1e3})
    with _registry_lock:
        pairs = list(_device_pairs)
    for i, (entry, t0, t1, h2d, d2h) in enumerate(pairs):
        common = {"name": entry, "cat": "device", "pid": pid, "tid": 0, "id": i}
        evs.append({**common, "ph": "b", "ts": t0 / 1e3,
                    "args": {"h2d_bytes": h2d, "d2h_bytes": d2h}})
        evs.append({**common, "ph": "e", "ts": t1 / 1e3})
    return {
        "traceEvents": evs,
        "displayTimeUnit": "ms",
        "timebase": {"perf_ns": time.perf_counter_ns(), "unix_ns": time.time_ns(), "pid": pid},
    }


def dump(path: str) -> str:
    """Write export_trace() to `path` as Perfetto-loadable JSON
    (ui.perfetto.dev; `tools/trace_summary.py` reads it); returns the
    path."""
    with open(path, "w") as f:
        json.dump(export_trace(), f)
    return path


def _label_escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def prometheus_text() -> str:
    """The registry in Prometheus text exposition format: spans as
    summaries (quantiles, _sum, _count), counters and gauges as
    label-keyed families (event names carry dots, so they ride in
    labels). The kernel launches are the counters `kernel.<entry>.launches`."""
    snap = snapshot()
    spans = {e: r for e, r in snap.items() if "p50_us" in r}
    counters = {e: r for e, r in snap.items() if "p50_us" not in r}
    lines = [
        "# HELP tbtpu_span_seconds Traced span latency by event.",
        "# TYPE tbtpu_span_seconds summary",
    ]
    for e, r in spans.items():
        lab = f'event="{_label_escape(e)}"'
        for q, key in (("0.5", "p50_us"), ("0.95", "p95_us"), ("0.99", "p99_us")):
            lines.append(f'tbtpu_span_seconds{{{lab},quantile="{q}"}} {r[key] / 1e6:.9g}')
        lines.append(f"tbtpu_span_seconds_sum{{{lab}}} {r['total_ms'] / 1e3:.9g}")
        lines.append(f"tbtpu_span_seconds_count{{{lab}}} {r['count']}")
    lines += [
        "# HELP tbtpu_span_max_seconds Maximum observed span latency.",
        "# TYPE tbtpu_span_max_seconds gauge",
    ]
    for e, r in spans.items():
        lines.append(f'tbtpu_span_max_seconds{{event="{_label_escape(e)}"}} {r["max_us"] / 1e6:.9g}')
    lines += [
        "# HELP tbtpu_events_total Counter registry (VSR, LSM, bus, kernel launches).",
        "# TYPE tbtpu_events_total counter",
    ]
    for e, r in counters.items():
        lines.append(f'tbtpu_events_total{{event="{_label_escape(e)}"}} {r["count"]}')
    lines += [
        "# HELP tbtpu_gauge Gauge registry (queue depths, table counts, device memory).",
        "# TYPE tbtpu_gauge gauge",
    ]
    g = gauges()
    occ = _stage_occupancy(lambda e: snap.get(e, {}).get("total_ms", 0.0), _op_window_ns())
    for stage, v in occ.items():
        g[f"op.occupancy.{stage}"] = v
    for name in sorted(g):
        lines.append(f'tbtpu_gauge{{name="{_label_escape(name)}"}} {g[name]:.9g}')
    return "\n".join(lines) + "\n"


async def serve_metrics(port: int, host: str = "127.0.0.1", extra=None):
    """Serve GET /metrics (Prometheus text), /trace (trace-event JSON),
    /lifecycle (lifecycle_summary) and /flight (the completed-op ring, a
    document `tools/trace_summary.py --ops` reads) on the running asyncio
    loop, and return the asyncio.Server. `extra` adds
    caller routes: {path_prefix: callable() -> (body bytes, content
    type)} (`cli start` mounts /cluster there)."""
    import asyncio

    async def _handle(reader, writer) -> None:
        try:
            async def _headers():
                req = await reader.readline()
                while True:
                    line = await reader.readline()
                    if not line or line in (b"\r\n", b"\n"):
                        return req

            # Bounded: a probe that never sends must not pin a coroutine.
            req = await asyncio.wait_for(_headers(), timeout=10)
            parts = req.split()
            path = parts[1].decode("latin-1") if len(parts) >= 2 else "/"
            status = "200 OK"
            if path.startswith("/metrics"):
                body = prometheus_text().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path.startswith("/trace"):
                body = json.dumps(export_trace()).encode()
                ctype = "application/json"
            elif path.startswith("/lifecycle"):
                body = json.dumps(lifecycle_summary()).encode()
                ctype = "application/json"
            elif path.startswith("/flight"):
                body = json.dumps({"ops": flight_records()}).encode()
                ctype = "application/json"
            elif extra is not None and any(path.startswith(p) for p in extra):
                fn = next(extra[p] for p in extra if path.startswith(p))
                body, ctype = fn()
            else:
                routes = "/metrics /trace /lifecycle /flight" + (
                    " " + " ".join(sorted(extra)) if extra else "")
                body = f"tigerbeetle_tpu_torch observability: {routes}\n".encode()
                ctype = "text/plain; charset=utf-8"
                status = "404 Not Found" if path != "/" else "200 OK"
            writer.write((
                f"HTTP/1.1 {status}\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
            ).encode() + body)
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.TimeoutError):
            pass
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001 — scrape teardown is best-effort
                pass

    return await asyncio.start_server(_handle, host, port)
