"""The device plane: per-kernel cost and roofline rows, the memory ledger
and the card's allocator, transfer bandwidth (the port of the reference
package's devicestats.py).

  - **Call shapes.** `note_call` records the argument shapes of each
    kernel-entry call while the tracer is enabled (duck-typed `.shape` /
    `.dtype` reads, never a device value); `retire_bucket` drops the
    rows of a scratch-ring bucket the workload stopped using, so the
    registry stays bounded.
  - **Cost model.** `COSTS` gives the least work of every kernel entry
    from its arguments' shapes: the bytes the function must move (each
    input read once, each output written once) and its integer
    operations. Where the work depends on the data (the accounts a
    registration installs, the sweeps of an exact batch, the radix passes
    of a sort plan, the rows a grouped writeback lands), a row takes the
    count as a keyword (chip_smoke.py computes it from its inputs) and
    otherwise bounds it from the shapes alone, so no row reads a value
    off the card. The reference's compiler cost analysis has no
    counterpart here.
  - **Cost table.** `cost_table()` joins each observed (entry, shape)
    with the tracer's `device.step.<entry>` / `device.<entry>` wall
    times: calls, ms per call, achieved GB/s, the roofline side
    (`classify`: operations per byte against the H100's balance point)
    and the share of the least time (`bound_share`). The costs come from
    the recorded shapes (rebuilt as meta tensors) when `/device` is
    read, never inside a dispatch window.
  - **Transfers.** `xfer_summary` reads the `device.xfer.{h2d,d2h}.gbps`
    histograms (stamped in tracer.device_finish) and the byte counters.
  - **Surfacing.** `device_status(replica)` is the `GET /device` payload
    (cli.py mounts it next to /cluster); tools/torch_device_top.py
    renders it. The card's own allocator report
    (`torch.cuda.memory_stats`) joins the owner-tagged ledger only where
    the replica's machine runs on CUDA and CUDA is already initialized:
    a `--device cpu` process never touches CUDA.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import torch

from tigerbeetle_tpu_torch import tracer

# H100 SXM published peaks: device memory rate and the 32-bit scalar rate
# outside the tensor cores (integer operations are counted against it).
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
# Operations per byte at which the card is compute- and memory-balanced
# (~20): below it a kernel is bounded by bytes, above it by operations.
BALANCE_OPS_PER_BYTE = INT_OPS_PER_S / HBM_BYTES_PER_S

_lock = threading.Lock()
_shapes: Dict[str, Dict[str, dict]] = {}  # tidy: guarded-by=_lock
_SHAPES_PER_ENTRY_MAX = 16  # bucket shapes are power-of-two padded: few


def _spec(x):
    """JSON-ready shape/dtype spec of one call argument: metadata reads
    only, recursing through NamedTuples and sequences; anything else
    rides as a literal (static arguments: counts, flags)."""
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return {"t": [int(d) for d in x.shape], "d": str(x.dtype).replace("torch.", "")}
    if isinstance(x, (tuple, list)):
        return {"s": [_spec(f) for f in x]}
    if x is None or isinstance(x, (bool, int, float, str)):
        return {"v": x}
    return {"v": repr(x)}


def _spec_key(spec) -> str:
    """"8192x4:uint32|8192:int32|=True"-style key over a spec's leaves,
    the row identity of one (entry, shape)."""
    parts = []

    def walk(s):
        if "t" in s:
            parts.append("x".join(str(d) for d in s["t"]) + ":" + s["d"])
        elif "s" in s:
            for f in s["s"]:
                walk(f)
        else:
            parts.append(f"={s['v']!r}")

    walk(spec)
    return "|".join(parts)


def note_call(entry: str, args: tuple, kwargs: Optional[dict] = None,
              bucket: Optional[int] = None) -> None:
    """Record one kernel-entry call's argument shapes (metadata reads
    only — never a device sync). `bucket` tags the row with its
    scratch-ring pad size."""
    if not tracer.enabled():
        return
    spec = _spec(tuple(args))
    kwspec = {k: _spec(v) for k, v in sorted((kwargs or {}).items())}
    key = _spec_key(spec)
    if kwspec:
        key += "|" + ",".join(f"{k}{_spec_key(v)}" for k, v in kwspec.items())
    with _lock:
        rows = _shapes.setdefault(entry, {})
        if key in rows or len(rows) < _SHAPES_PER_ENTRY_MAX:
            rows[key] = {"spec": spec, "kwspec": kwspec, "bucket": bucket}


def reset() -> None:
    """Forget every recorded shape (a run that reads the shapes of one
    window calls it first)."""
    with _lock:
        _shapes.clear()


def retire_bucket(bucket: int) -> None:
    """Drop every shape row tagged with a retired scratch-ring bucket."""
    with _lock:
        for entry, rows in list(_shapes.items()):
            for k in [k for k, r in rows.items() if r["bucket"] == bucket]:
                del rows[k]
            if not rows:
                del _shapes[entry]


def observed_shapes() -> Dict[str, list]:
    with _lock:
        return {e: sorted(rows) for e, rows in _shapes.items()}


def observed_specs() -> Dict[str, Dict[str, dict]]:
    """entry -> shape key -> {"spec", "kwspec"} of every recorded row."""
    with _lock:
        return {e: {k: {"spec": r["spec"], "kwspec": r["kwspec"]} for k, r in rows.items()}
                for e, rows in _shapes.items()}


def args_of(spec):
    """The arguments a spec describes, tensors as meta tensors of its
    shapes and dtypes (NamedTuples come back as plain tuples): what a
    COSTS row needs, with no memory and no device behind it."""
    if "t" in spec:
        return torch.empty(spec["t"], dtype=getattr(torch, spec["d"]), device="meta")
    if "s" in spec:
        return tuple(args_of(f) for f in spec["s"])
    return spec["v"]


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _log2(n: int) -> int:
    return max(int(n), 1).bit_length()


# The commit kernels' arguments, by position: a LedgerState's four
# balance tables (A, 4) u32 come first, then ledger and flags (A,); a
# TransferBatch holds ten event columns, dr_slot second.


def _ctf(state, b, host):
    # the four balance tables in and out, the batch and its host codes
    # in, the ledger and flags words of both slots gathered, a code an
    # event and the bail word out; ~24 operations a table row (the
    # whole-table overflow check), ~120 an event (the ladder).
    n = b[1].shape[0]
    return (2 * _nbytes(*state[:4]) + _nbytes(*b, host) + 2 * n * 4 + 4 * n + 1,
            24 * state[0].shape[0] + 120 * n)


def _register(state, slots, ledger, flags, mask, k_in=None):
    # slots, ledger, flags and mask in; a ledger and a flags word written
    # for each account installed (`k_in`, the mask's count, where the
    # caller counted it, else every row).
    k = slots.shape[0]
    return (_nbytes(slots, ledger, flags, mask) + 8 * (k if k_in is None else k_in), 4 * k)


def _read(state, slots, out=None):
    # the slots in; four (k, 4) rows gathered and four written.
    k = slots.shape[0]
    return _nbytes(slots) + 2 * 4 * k * 16, 8 * k


def _write(state, slots, dp, dpo, cp, cpo):
    # the slots and four (k, 4) blocks in, four (k, 4) rows stored.
    k = slots.shape[0]
    return _nbytes(slots, dp, dpo, cp, cpo) + 4 * k * 16, 8 * k


def _exact(state, b, host, pending, chain, plan=None, max_sweeps=64,
           has_pv=True, has_chains=True, sweeps=None):
    # the four tables in and out; the batch, its host codes, the pending
    # rows, the chains (and the sort plan, where the caller passes one)
    # in; ledger and flags of both slots gathered; a code, an amount and
    # both sides' observed balances an event out, and the bail word.
    # Operations: the table copy and check, then per sweep the
    # reference's segmented sums (~10 per lane of its 52 u64 lanes over
    # 2n records) plus ~200 per event of ladder, for this batch's
    # `sweeps` where the caller counted them, else max_sweeps.
    n = b[1].shape[0]
    inputs = _nbytes(*b, host, *pending, chain) + (0 if plan is None else _nbytes(*plan))
    runs = max_sweeps if sweeps is None else sweeps
    return (2 * _nbytes(*state[:4]) + inputs + 2 * 2 * n * 4 + n * (4 + 16 + 2 * 64) + 1,
            8 * state[0].shape[0] + runs * (2 * n * 52 * 10 + n * 200))


def _sort_plan(b, pending, chain, a, passes=None):
    # seven (n,) int32 columns in (flags, both slots, both pending slots,
    # chains, groups); four (2n,) and four (n,) int32 columns out. ~40
    # operations an element for each 8-bit digit pass over the bits the
    # keys span (`passes` = (record passes, event passes) where the
    # caller counted this batch's, else the widest keys: a slot of
    # log2(a + 1) bits with an event's chain, and a group), and ~20 for
    # its heads.
    n = b[1].shape[0]
    if passes is None:
        passes = (-(-(_log2(a) + _log2(n)) // 8), -(-_log2(n) // 8))
    rec, ev = passes
    return 7 * 4 * n + 4 * (2 * n * 4 + n * 4), (rec * 2 * n + ev * n) * 40 + 3 * n * 20


def _register_grouped(tables, slots, ledger, flags, mask, k_in=None):
    # as register_accounts, its ledger and flags words written into every
    # table; a mask test and a slot normalization a row, two stores a
    # table and installed row.
    k = slots.shape[0]
    k_in = k if k_in is None else k_in
    return (_nbytes(slots, ledger, flags, mask) + 8 * k_in * len(tables),
            4 * k + 2 * k_in * len(tables))


def _write_grouped(states, bases, slots, dp, dpo, cp, cpo, a, landed=None):
    # the slots and the four (k, 4) blocks in once, 64 bytes written a
    # landed row and table (a row lands in each table whose rows hold its
    # slot: `landed` pairs where the caller counted them, else every slot
    # in as many tables as cover one slot of [0, a)); a slot compare a
    # table.
    k = slots.numel()
    if landed is None:
        landed = k * -(-len(states) * states[0][0].shape[0] // a)
    return (_nbytes(slots, dp, dpo, cp, cpo) + 64 * landed,
            k * (4 + 2 * len(states)))


# entry -> (its call's arguments -> (bytes, integer operations)): the
# bytes the function must move (each input read once, each output written
# once) and a count of its integer operations, from the shapes alone.
COSTS = {  # tidy: atomic — immutable constant table, never written after import
    "create_transfers_fast": _ctf,
    "register_accounts": _register,
    "read_balances": _read,
    "write_balances": _write,
    "create_transfers_exact": _exact,
    "exact_sort_plan": _sort_plan,
    "register_accounts_sharded": _register_grouped,
    "write_balances_sharded": _write_grouped,
    # cols, ts, rows, pad in; keys and payload (5 n, 3) u32 out; ~40
    # operations a record.
    "query_index_keys": lambda cols, ts, rows, pad: (
        _nbytes(cols, ts, rows, pad) + 2 * 5 * rows.numel() * 12,
        40 * rows.numel(),
    ),
    # the same bytes; a stable sort of 5 n rows of the function, whatever
    # the design: ~4 operations a row (a 96-bit compare and a move) for
    # each of log2(n) merge levels.
    "query_index_keys_sorted": lambda cols, ts, rows, pad: (
        _nbytes(cols, ts, rows, pad) + 2 * 5 * rows.numel() * 12,
        40 * rows.numel() + 4 * 5 * rows.numel() * max(1, (rows.numel() - 1).bit_length()),
    ),
    # both runs in, their merge out; ~8 operations a key compare, and
    # about five compares a row: its merge step, its share of a thread's
    # merge-path search in shared memory (9 steps for 3 rows) and of the
    # tile's two co-rank searches (3 rounds of up to 64 probes for 384 rows).
    "merge_kernel_tiled": lambda ka, pa, kb, pb, tile=None: (
        2 * _nbytes(ka, pa, kb, pb),
        (ka.shape[0] + kb.shape[0]) * 8 * 5,
    ),
    # both runs in, their merge out; the tiled merge's compares (about
    # five of ~8 operations a row), and a source lookup and an address a
    # payload word (~4 operations).
    "merge_kernel": lambda ka, pa, kb, pb: (
        2 * _nbytes(ka, pa, kb, pb),
        (ka.shape[0] + kb.shape[0]) * 8 * 5 + 4 * (pa.numel() + pb.numel()),
    ),
    # the stack in, its merge out; a merge step a row at each of the
    # log2(k) levels of the in-tile tree, and a binary search over a run
    # for each of the k - 1 other runs of each sample (one row in
    # min(b, 8192 / k)).
    "compact_fold_kernel": lambda keys, pays: (
        2 * _nbytes(keys, pays),
        keys.shape[0] * keys.shape[1] * (_log2(keys.shape[0]) - 1) * 8
        + keys.shape[0] * keys.shape[1] // min(keys.shape[1], max(1, 8192 // keys.shape[0]))
        * (keys.shape[0] - 1) * 8 * _log2(keys.shape[1]),
    ),
    # both arrays in, one byte a candidate out; a binary search each.
    "scan_intersect_mask": lambda cand, run: (
        _nbytes(cand, run) + cand.numel(),
        cand.numel() * 4 * _log2(run.numel()),
    ),
    # parallel/sharding.py, the commit over a device mesh. The k events
    # [lo, lo + k) (ten fields and the host code: one dp slice, or the
    # slices one card validates) and two ledger words an event in, a code
    # and a routing byte an event out; ~60 operations an event.
    "sharded_validate": lambda state, b, host_code, lo, k: (
        (sum(_nbytes(x) // x.shape[0] for x in (*b, host_code)) + 8 + 5) * k,
        60 * k,
    ),
    # the shard's four tables in and out, the events' slots, amounts,
    # masks (and removal amounts) in; ~24 operations a row, ~80 an event.
    "sharded_apply": lambda state, dr, cr, amount, p_amount, mask, base: (
        2 * _nbytes(*state[:4]) + _nbytes(dr, cr, amount, mask)
        + (0 if p_amount is None else _nbytes(p_amount)) + 1,
        24 * state[0].shape[0] + 80 * dr.shape[0],
    ),
    # every shard's four tables in and out, the events once (every shard of
    # a launch reads one copy); the operations of sharded_apply a shard.
    "sharded_apply_grouped": lambda states, bases, dr, cr, amount, p_amount, mask: (
        sum(2 * _nbytes(*st[:4]) for st in states) + _nbytes(dr, cr, amount, mask)
        + (0 if p_amount is None else _nbytes(p_amount)) + 1,
        len(states) * (24 * states[0][0].shape[0] + 80 * dr.shape[0]),
    ),
    # the slots in, four (k, 4) blocks out, and the rows the shard owns
    # read once (`owned` of them where the caller counted them, else k).
    "sharded_read": lambda state, slots, base, a, owned=None: (
        _nbytes(slots) + 64 * slots.shape[0] + 64 * (slots.shape[0] if owned is None else owned),
        8 * slots.shape[0],
    ),
    # the slots in, four (k, 4) blocks out, and the rows the launch's
    # shards own read once (`owned` of them where the caller counted
    # them, else k: every row of a dp row has its owner among them).
    "sharded_read_grouped": lambda states, bases, slots, a, owned=None: (
        _nbytes(slots) + 64 * slots.shape[0] + 64 * (slots.shape[0] if owned is None else owned),
        8 * slots.shape[0],
    ),
}
COSTS["sharded_validate_grouped"] = COSTS["sharded_validate"]


def cost(entry: str, args: tuple, **counts):
    """(bytes, integer operations) of one call of `entry` on `args`;
    `counts` are the data-dependent counts a row takes (k_in, sweeps,
    passes, landed, owned), where the caller has them."""
    return COSTS[entry](*args, **counts)


def classify(ops: Optional[float], nbytes: Optional[float]) -> str:
    """The roofline side of a call: "operations" where its operations per
    byte exceed the card's balance point (~20), else "bytes"; "n/a"
    where either count is missing."""
    if not ops or not nbytes:
        return "n/a"
    return "operations" if ops / nbytes > BALANCE_OPS_PER_BYTE else "bytes"


def _row_cost(entry: str, row: dict):
    if entry not in COSTS:
        return None, None
    kwargs = {k: args_of(v) for k, v in row["kwspec"].items()}
    return cost(entry, args_of(row["spec"]), **kwargs)


def cost_table(snap: Optional[dict] = None) -> list:
    """One row per observed (entry, shape): the COSTS bytes and
    operations at the recorded shapes joined with the entry's
    `device.step.<entry>` (a dispatch window) or `device.<entry>` (a
    blocking call) wall times. `achieved_gbps` is the row's bytes over
    the mean ms per call, `bound_ms` the least time (the larger of bytes
    over 3.35 TB/s and operations over 67 TOP/s), `bound_share` that
    over the mean ms per call. Rows sort by entry, then shape."""
    if snap is None:
        snap = tracer.snapshot()
    rows = []
    for entry, shape_rows in observed_specs().items():
        rt = snap.get(f"device.step.{entry}") or snap.get(f"device.{entry}")
        ms_call = (rt["avg_us"] / 1e3) if rt else None
        for key, rec in shape_rows.items():
            nbytes, ops = _row_cost(entry, rec)
            bound_ms = None
            if nbytes is not None:
                bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S) * 1e3
            row = {
                "entry": entry,
                "shape": key,
                "spec": rec["spec"],
                "kwspec": rec["kwspec"],
                "calls": rt["count"] if rt else 0,
                "ms_per_call": round(ms_call, 4) if ms_call else None,
                "bytes": nbytes,
                "ops": ops,
                "bound": classify(ops, nbytes),
                "bound_ms": bound_ms,
                "achieved_gbps": None,
                "bound_share": None,
            }
            if ms_call and nbytes:
                row["achieved_gbps"] = round(nbytes / (ms_call * 1e6), 3)
                row["bound_share"] = bound_ms / ms_call
            rows.append(row)
    rows.sort(key=lambda r: (r["entry"], r["shape"]))
    return rows


def xfer_summary(snap: Optional[dict] = None) -> dict:
    """Transfer-bandwidth ledger: per-direction achieved GB/s
    percentiles (the raw MB/s histograms read back through the p50_us
    convention of tracer.device_finish), cumulative byte counters, and
    bytes per committed transfer (total transfer volume over
    sm.stored_transfers; absent before any transfer committed)."""
    if snap is None:
        snap = tracer.snapshot()
    out: Dict[str, Any] = {}
    for d in ("h2d", "d2h"):
        hist = snap.get(f"device.xfer.{d}.gbps")
        if hist:
            out[f"{d}_gbps_p50"] = hist["p50_us"]
            out[f"{d}_gbps_p99"] = hist["p99_us"]
            out[f"{d}_windows"] = hist["count"]
        cnt = snap.get(f"device.{d}_bytes")
        out[f"{d}_bytes"] = cnt["count"] if cnt else 0
    stored = snap.get("sm.stored_transfers", {}).get("count", 0)
    if stored:
        out["bytes_per_transfer"] = round(
            (out["h2d_bytes"] + out["d2h_bytes"]) / stored, 1
        )
    return out


def _cuda_memory(device) -> Optional[dict]:
    """The CUDA caching allocator's report for `device` (host-side
    counters: no device sync), only where CUDA is already initialized in
    this process: a CPU replica must never start a CUDA context because
    its /device was scraped."""
    if device is None or device.type != "cuda" or not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "reserved_bytes": int(stats.get("reserved_bytes.all.current", 0)),
        "source": "torch.cuda.memory_stats",
    }


def device_status(replica=None) -> dict:
    """The GET /device payload: the cost and roofline table, the memory
    ledger (with the card's allocator report where the replica runs on
    CUDA), the transfer summary, the open dispatch windows and the commit
    depth. Reads host-side registries only, so a scrape on the event
    loop never waits on the card."""
    snap = tracer.snapshot()
    mem = tracer.device_mem_totals()
    device = getattr(getattr(replica, "state_machine", None), "device", None)
    cuda_mem = _cuda_memory(device)
    if cuda_mem:
        mem["backend_reported"] = cuda_mem
    status = {
        "backend": device.type if device is not None else "none",
        "tracing": tracer.enabled(),
        "entries": cost_table(snap),
        "mem": mem,
        "xfer": xfer_summary(snap),
        "inflight": tracer.device_inflight(),
    }
    if cuda_mem:
        status["device_name"] = torch.cuda.get_device_name(device)
    if replica is not None:
        depth = getattr(replica, "commit_depth", None)
        if depth is not None:
            status["commit_depth"] = int(depth)
    return status
