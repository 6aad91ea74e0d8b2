"""Spans, counters, gauges and device windows (slim copy of the reference
package's tracer.py: the calls the state machine and the LSM make).

  - `span(event)` times a scoped host region: per-event count, total and
    max nanoseconds.
  - `count` / `gauge`: counters and last-write-wins gauges.
  - `device_mem_set` / `device_mem_adjust` / `device_mem_retire_prefix`:
    the owner-tagged device memory ledger (`device.mem.<owner>.bytes`
    gauges plus a high-water total).
  - `device_step(entry)`: a span over a blocking kernel call.
  - `device_dispatch(entry)` / `device_finish(entry, token)`: the
    split-phase window. On a CUDA stream the token carries a CUDA event
    recorded at dispatch; finish records a second event, waits for it (it
    runs only where the caller synchronises anyway) and records the
    device time between the two under `device.step.<entry>`. Off CUDA the
    window is the host clock between the two calls.

Off until `enable()`; disabled, every call returns after one
module-global check and allocates nothing.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

_enabled = False

_lock = threading.Lock()
_agg: Dict[str, list] = {}  # event -> [count, total_ns, max_ns]
_counters: Dict[str, int] = {}
_gauges: Dict[str, float] = {}
_device_mem: Dict[str, int] = {}
_device_mem_hw = [0]

# The kernel entries whose device windows the state machine opens.
DEVICE_ENTRIES = frozenset({
    "create_transfers_fast", "create_transfers_exact", "register_accounts",
    "read_balances", "write_balances",
    # the store stage's query index and the query intersect
    "query_index_keys", "query_index_keys_sorted", "merge_kernel_tiled",
    "scan_intersect_mask",
    # compaction: the chunk fold and the rank merge
    "compact_fold_kernel", "merge_kernel",
    # the commit path over balance tables sharded on a device mesh
    "sharded.create_transfers_fast", "sharded.create_transfers_exact",
    "sharded.register_accounts", "sharded.read_balances", "sharded.write_balances",
})


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    with _lock:
        _agg.clear()
        _counters.clear()
        _gauges.clear()
        _device_mem.clear()
        _device_mem_hw[0] = 0


def observe(event: str, duration_ns: int) -> None:
    if not _enabled:
        return
    with _lock:
        agg = _agg.get(event)
        if agg is None:
            agg = _agg[event] = [0, 0, 0]
        agg[0] += 1
        agg[1] += duration_ns
        if duration_ns > agg[2]:
            agg[2] = duration_ns


class _Span:
    __slots__ = ("event", "t0")

    def __init__(self, event: str) -> None:
        self.event = event

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        observe(self.event, time.perf_counter_ns() - self.t0)
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SPAN = _NullSpan()


def null_span() -> _NullSpan:
    return _NULL_SPAN


def span(event: str):
    """Time a scoped region under `event`."""
    if not _enabled:
        return _NULL_SPAN
    return _Span(event)


def count(event: str, n: int = 1) -> None:
    if not _enabled:
        return
    with _lock:
        _counters[event] = _counters.get(event, 0) + n


def gauge(name: str, value: float) -> None:
    if not _enabled:
        return
    with _lock:
        _gauges[name] = value


def device_mem_set(owner: str, nbytes: int) -> None:
    """Set an owner's live device bytes (absolute)."""
    if not _enabled:
        return
    with _lock:
        _device_mem[owner] = int(nbytes)
        _gauges[f"device.mem.{owner}.bytes"] = float(nbytes)
        _device_mem_hw[0] = max(_device_mem_hw[0], sum(_device_mem.values()))


def device_mem_adjust(owner: str, delta: int) -> None:
    """Adjust an owner's live device bytes by a delta (clamped at 0: a
    release racing a reset must not publish negative residency)."""
    if not _enabled:
        return
    with _lock:
        v = max(0, _device_mem.get(owner, 0) + int(delta))
        _device_mem[owner] = v
        _gauges[f"device.mem.{owner}.bytes"] = float(v)
        _device_mem_hw[0] = max(_device_mem_hw[0], sum(_device_mem.values()))


def device_mem_retire_prefix(prefix: str) -> None:
    """Retire every ledger owner (and gauge) under a tag prefix."""
    if not _enabled:
        return
    with _lock:
        for owner in [o for o in _device_mem if o.startswith(prefix)]:
            del _device_mem[owner]
        gp = f"device.mem.{prefix}"
        for name in [n for n in _gauges if n.startswith(gp)]:
            del _gauges[name]


def _check_entry(entry: str) -> None:
    if entry not in DEVICE_ENTRIES:
        raise ValueError(f"unknown device entry {entry!r}")


def device_step(entry: str):
    """Span over a BLOCKING kernel entry (call + materialization)."""
    if not _enabled:
        return _NULL_SPAN
    _check_entry(entry)
    return span(f"device.{entry}")


class _Window:
    __slots__ = ("t0", "event")

    def __init__(self, t0: int, event) -> None:
        self.t0 = t0
        self.event = event


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
    when disabled)."""
    if not _enabled:
        return 0
    _check_entry(entry)
    count(f"device.{entry}.dispatches")
    if h2d_bytes:
        count("device.h2d_bytes", h2d_bytes)
    return _Window(time.perf_counter_ns(), _cuda_event())


def device_finish(entry: str, token, d2h_bytes: int = 0) -> None:
    """Close a dispatch window: `device.step.<entry>` gets the device
    time between the dispatch and this call (host time off CUDA)."""
    if not _enabled or not token:
        return
    if d2h_bytes:
        count("device.d2h_bytes", d2h_bytes)
    if token.event is not None:
        end = _cuda_event()
        end.synchronize()
        observe(f"device.step.{entry}", int(token.event.elapsed_time(end) * 1e6))
    else:
        observe(f"device.step.{entry}", time.perf_counter_ns() - token.t0)


def device_bytes(h2d: int = 0, d2h: int = 0) -> None:
    """Count transfer bytes for a blocking entry (device_step path)."""
    if not _enabled:
        return
    if h2d:
        count("device.h2d_bytes", h2d)
    if d2h:
        count("device.d2h_bytes", d2h)


def snapshot() -> Dict[str, dict]:
    """event → {count, total_ms, avg_us, max_us} for spans; counters
    appear with total_ms 0."""
    with _lock:
        agg = {k: list(v) for k, v in _agg.items()}
        counters = dict(_counters)
    out: Dict[str, dict] = {}
    for event in sorted(agg):
        n, total, mx = agg[event]
        out[event] = {
            "count": n,
            "total_ms": total / 1e6,
            "avg_us": total / n / 1e3 if n else 0.0,
            "max_us": mx / 1e3,
        }
    for event in sorted(counters):
        rec = out.setdefault(
            event, {"count": 0, "total_ms": 0.0, "avg_us": 0.0, "max_us": 0.0}
        )
        rec["count"] += counters[event]
    return out

