"""In-process profiler of one replica's request-to-commit pipeline.

Feeds sealed REQUEST messages straight into `Replica.on_message` (no TCP)
with the full four-thread pipeline attached: the loop (this thread, which
drains the workers' posted callbacks), the `WalWriter`, the
`CommitExecutor` at `commit_depth` and the `StoreExecutor`. Warm-up
batches run before the measured window; then everything is reported from
the tracer registry:

  - ms per batch for each disjoint stage, with p50/p99 of its span;
  - the query-index, compaction and bus-codec sub-spans, the worker
    threads' busy time, and the stall and idle rows;
  - `tracer.lifecycle_summary()` (per-op queue/service decomposition);
  - `devicestats.cost_table` and `xfer_summary` with the device memory
    ledger (the card's kernels only);
  - a post-window query probe over the committed transfers;
  - a trace of the thread overlap, written with `tracer.dump(path)`
    (`tools/trace_summary.py PATH` summarises it).

The registry is the one timing source. The wall clock only checks the
`server.total` span (within 5%); every batch must reply and none may be
shed; the disjoint stage rows may not sum past `server.total` when the
commit runs on the loop (`--serial-commit`); and no kernel library may be
built inside the window (the counterpart of the reference's retrace
check: `ops/kernels.py` builds each source once, and a build there would
put nvcc inside the measurement).

    python -m tigerbeetle_tpu_torch.profile_e2e                 # the card, production, 40 x 8190
    python -m tigerbeetle_tpu_torch.profile_e2e --serial-commit --serial-store
    python -m tigerbeetle_tpu_torch.profile_e2e --depth 4 --trace /tmp/e2e.json
    python -m tigerbeetle_tpu_torch.profile_e2e --device cpu --config test_min --batches 6

It runs on the card unless `--device cpu` is given, and raises without
one. `run()` returns the record the reference appends to its devhub
series (`metric`, `value`, `unit`, `extra` with the stage rows and the
lifecycle), with the run's digests and trace path beside it; this module
writes no series.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import tempfile
import time
from collections import deque
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from tigerbeetle_tpu_torch import devicestats, tracer, types
from tigerbeetle_tpu_torch.constants import config_by_name
from tigerbeetle_tpu_torch.io.storage import FileStorage, Zone
from tigerbeetle_tpu_torch.ops import kernels
from tigerbeetle_tpu_torch.vsr import header as hdr
from tigerbeetle_tpu_torch.vsr.header import Command, Message, Operation
from tigerbeetle_tpu_torch.vsr.journal import WalWriter
from tigerbeetle_tpu_torch.vsr.replica import Replica

BATCH = 8190
ACCOUNTS = 10_000
CLIENT_ID = 0x1234567

# Disjoint stage rows (span names). With the commit executor, execute and
# reply run on the commit thread and exclude each other; on the serial
# path the reply and the store barrier nest inside replica.execute and
# are subtracted from it.
STAGES = {
    "parse": ("stage.parse",),
    "wal": ("journal.write_prepare", "stage.wal"),
    "replicate": ("stage.replicate",),
    "execute": ("replica.execute",),
    "reply": ("stage.reply",),
}
STORE_ROWS = {
    "store.log": ("sm.store.log",),
    "store.idx": ("sm.store.idx",),
    "store.rows": ("sm.store.rows",),
    "store.query": ("sm.store.query",),
    "beat": ("sm.beat",),
}
QUERY_ROWS = {
    "query.keys": ("sm.store.query.keys",),
    "query.sort": ("lsm.query_rows.flush.sort",),
    "query.merge": ("lsm.query_rows.flush.merge",),
    "query.build": ("lsm.query_rows.flush.build",),
    "query.prefetch": ("pipeline.store.prefetch",),
}
COMPACT_ROWS = {
    "compact.beat": ("sm.beat",),
    "compact.forward": ("lsm.compact.forward",),
    "compact.merge": ("lsm.compact.merge",),
    "compact.bloom": ("lsm.compact.bloom",),
    "compact.build": ("lsm.compact.build",),
    "compact.device": ("device.step.compact_fold_kernel",),
}
BUS_ROWS = {
    "bus.scan": ("bus.scan",),
    "bus.decode": ("bus.decode",),
    "bus.encode": ("bus.encode",),
}
STALL_ROWS = ("pipeline.commit.idle", "pipeline.store.idle",
              "pipeline.wal.idle", "pipeline.store.stall")


class DummyBus:
    """The replica's bus with no network: replies are kept, replica
    traffic (a one-replica cluster sends none that matters) dropped."""

    def __init__(self) -> None:
        self.replies: List[Message] = []

    def send_to_replica(self, r, msg) -> None:
        pass

    def send_to_client(self, c, msg) -> None:
        self.replies.append(msg)


def sealed_requests(accounts: int, batch: int, n: int,
                    seed: int = 7) -> List[Message]:
    """The profiled stream as sealed REQUEST messages, in feed order:
    register; `accounts` accounts on ledger 1 in batches of `batch`; then
    `n` batches of `batch` transfers between random distinct accounts with
    amounts 1-999 (the reference's stream, seeded)."""
    ops = [(Operation.REGISTER, b"")]
    ids = np.arange(1, accounts + 1, dtype=np.uint64)
    for s in range(0, accounts, batch):
        chunk = ids[s:s + batch]
        ev = np.zeros(len(chunk), dtype=types.ACCOUNT_DTYPE)
        ev["id_lo"] = chunk
        ev["ledger"] = 1
        ev["code"] = 10
        ops.append((Operation.CREATE_ACCOUNTS, ev.tobytes()))
    rng = np.random.default_rng(seed)
    next_id = 1
    for _ in range(n):
        ev = np.zeros(batch, dtype=types.TRANSFER_DTYPE)
        ev["id_lo"] = np.arange(next_id, next_id + batch, dtype=np.uint64)
        next_id += batch
        dr = rng.integers(1, accounts + 1, batch).astype(np.uint64)
        cr = rng.integers(1, accounts + 1, batch).astype(np.uint64)
        cr = np.where(cr == dr, (cr % accounts) + 1, cr)
        ev["debit_account_id_lo"] = dr
        ev["credit_account_id_lo"] = cr
        ev["amount_lo"] = rng.integers(1, 1000, batch)
        ev["ledger"] = 1
        ev["code"] = 7
        ops.append((Operation.CREATE_TRANSFERS, ev.tobytes()))
    out = []
    for k, (operation, body) in enumerate(ops, start=1):
        h = hdr.make(Command.REQUEST, 0, client=CLIENT_ID, request=k,
                     operation=operation)
        out.append(Message(h, body).seal())
    return out


def stream_shape(config: str) -> Tuple[int, int]:
    """(accounts, batch) of the profiled stream at `config`: the
    reference's 10,000 accounts and 8190-event batches, cut to what the
    config holds (a quarter of its accounts, its batch_max)."""
    cfg = config_by_name(config)
    return min(ACCOUNTS, cfg.accounts_max // 4), min(BATCH, cfg.batch_max)


def balances_digest(sm, accounts: int) -> str:
    """sha256 of every account's four balance columns, read through the
    state machine's lookup (timestamps left out: they follow the clock)."""
    ids = np.arange(1, accounts + 1, dtype=np.uint64)
    rows = sm.lookup_accounts(ids, np.zeros_like(ids))
    h = hashlib.sha256()
    for f in ("debits_pending", "debits_posted", "credits_pending",
              "credits_posted"):
        for part in ("_lo", "_hi"):
            h.update(np.ascontiguousarray(rows[f + part]).tobytes())
    return h.hexdigest()


def replies_digest(replies: List[Message]) -> str:
    """sha256 of every reply body, each behind its length (an empty body
    still counts)."""
    h = hashlib.sha256()
    for m in replies:
        body = bytes(m.body)
        h.update(len(body).to_bytes(4, "little") + body)
    return h.hexdigest()


def run(device: str = "cuda", batches: int = 40, warmup: int = 8,
        overlap: bool = True, store_async: bool = True, commit_depth: int = 0,
        config: str = "production", trace_path: Optional[str] = None,
        frozen_time: bool = False,
        out: Callable[[str], None] = print) -> dict:
    """Profile `batches` transfer batches through one replica on `device`
    and return the record (stage rows, lifecycle, digests, trace path).
    `warmup` batches run first, outside the window (8 cover a flush
    cycle of the device key build at PRODUCTION, so the window builds
    no kernel library and meets no first flush).
    `frozen_time` puts the replica on DeterministicTime(tick_ns=0), so its
    commit checksums are a function of the stream alone."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "profile_e2e runs on the card: no CUDA device here "
            "(pass --device cpu for the CPU run)")
    accounts, batch = stream_shape(config)
    if device == "cuda":
        kernels.build_all()  # every library before the window
    tracer.reset()
    tracer.enable()
    tmp = tempfile.mkdtemp(prefix="tbtorch-prof-")
    path = os.path.join(tmp, "prof.tigerbeetle")
    cfg = config_by_name(config)
    zone = Zone.for_config(
        cfg.journal_slot_count, cfg.message_size_max,
        grid_block_count=cfg.grid_block_count,
        grid_block_size=cfg.lsm_block_size,
    )
    storage = FileStorage(path, size=zone.total_size, create=True)
    Replica.format(storage, zone, 0, 0, 1)
    storage.close()
    storage = FileStorage(path)
    bus = DummyBus()
    clock = None
    if frozen_time:
        from tigerbeetle_tpu_torch.vsr.clock import DeterministicTime

        clock = DeterministicTime(tick_ns=0)
    replica = Replica(
        cluster=0, replica_index=0, replica_count=1, storage=storage,
        zone=zone, config=cfg, bus=bus, device=device, time=clock,
    )
    replica.open()

    # Worker threads post loop-side callbacks onto `posts`, drained by
    # pump(): this thread stands in for the asyncio loop.
    posts: deque = deque()
    if overlap or store_async:
        replica.wal_writer = WalWriter(storage, posts.append)
        replica.journal.writer = replica.wal_writer
    if overlap:
        replica.attach_executor(posts.append, commit_depth=commit_depth)
    if store_async:
        replica.attach_store_executor(posts.append)

    def pump() -> None:
        while posts:
            posts.popleft()()

    def pace() -> None:
        """Wait, as a client's flow control would, until the pipeline has
        room: past pipeline_max the front door sheds a request with BUSY,
        and a shed batch would vanish from the run."""
        while (len(replica.pipeline) >= replica.config.pipeline_max
               or replica.request_queue):
            pump()
            time.sleep(0.0002)

    def settle(expect: int, deadline_s: float = 600.0) -> None:
        """Pump until `expect` replies are out (the sleep yields the
        interpreter lock to the worker threads)."""
        t_end = time.perf_counter() + deadline_s
        while len(bus.replies) < expect:
            pump()
            if len(bus.replies) >= expect:
                break
            if time.perf_counter() > t_end:
                raise RuntimeError(f"stalled: {len(bus.replies)}/{expect} replies")
            time.sleep(0.0002)

    try:
        t0 = time.perf_counter()
        msgs = sealed_requests(accounts, batch, batches + warmup)
        seal_s = time.perf_counter() - t0
        n_setup = len(msgs) - batches - warmup
        for m in msgs[:n_setup]:  # register, then the accounts
            n_before = len(bus.replies)
            replica.on_message(m)
            settle(n_before + 1)
        transfers = msgs[n_setup:]

        # The ingress the server bus runs: the C scan and decode of each
        # message's wire bytes, so the parse row attributes the codec.
        from tigerbeetle_tpu_torch.net import codec

        scanner = codec.scanner()
        frames = [m.to_bytes() for m in transfers] if scanner is not None else None

        n_warm = len(bus.replies)
        for m in transfers[:warmup]:
            pace()
            replica.on_message(m)
            pump()
        settle(n_warm + warmup)
        if replica.store_executor is not None:
            replica.store_executor.drain()
            pump()
        if device == "cuda":
            torch.cuda.synchronize()
        transfers = transfers[warmup:]
        if frames is not None:
            frames = frames[warmup:]
        builds0 = kernels.BUILD_COUNT

        tracer.reset()  # measure only the transfer load (all threads re-arm)
        launches0 = dict(kernels.LAUNCHES)
        n0 = len(bus.replies)
        wall0 = time.perf_counter()
        with tracer.span("server.total"):
            for mi, m in enumerate(transfers):
                pace()
                with tracer.span("stage.parse"):
                    if scanner is not None:
                        raw = frames[mi]
                        with tracer.span("bus.scan"):
                            rows, _consumed, _need, status = scanner.scan(raw)
                        assert status == codec.STATUS_OK and len(rows) == 1
                        with tracer.span("bus.decode"):
                            m = codec.messages_from_scan(raw, rows)[0]
                    else:
                        assert m.header.valid_checksum_body(m.body)
                replica.on_message(m)
                pump()
            settle(n0 + batches)
        wall_s = time.perf_counter() - wall0
        drain_s = 0.0
        if replica.store_executor is not None:
            t0d = time.perf_counter()
            replica.store_executor.drain()
            drain_s = time.perf_counter() - t0d
            pump()
        builds = kernels.BUILD_COUNT - builds0
        assert len(bus.replies) - n0 == batches, (len(bus.replies) - n0, batches)
        # Every reply of the run answers a committed request (none is BUSY).
        shed = [m.header["request"] for m in bus.replies
                if m.header["command"] != Command.REPLY]
        assert not shed, f"requests {shed} were shed"

        snap = tracer.snapshot()
        record = _report(snap, out, device=device, config=config,
                         batches=batches, batch=batch, warmup=warmup,
                         overlap=overlap, store_async=store_async,
                         depth=replica.commit_depth, wall_s=wall_s,
                         drain_s=drain_s, seal_s=seal_s, builds=builds,
                         native_bus=scanner is not None)
        sm = replica.state_machine
        if replica.store_executor is not None:
            replica.store_executor.drain()
        record["extra"]["stages"].update(_query_probe(sm, accounts, batch, out))
        record["replies_digest"] = replies_digest(bus.replies)
        record["balances_digest"] = balances_digest(sm, accounts)
        record["commit_checksum"] = replica.commit_checksums.get(replica.commit_min)
        record["commit_checksums"] = dict(replica.commit_checksums)
        # The kernels launched since the tracer's reset: those whose
        # device windows the trace holds.
        record["traced_launches"] = {
            k: n - launches0.get(k, 0) for k, n in kernels.LAUNCHES.items()}
        record["trace"] = tracer.dump(
            trace_path or os.path.join(tmp, "trace_e2e.json"))
        out(f"\ntrace: {record['trace']} (ui.perfetto.dev; summarize: "
            f"python tools/trace_summary.py {record['trace']})")
        return record
    finally:
        for ex in (replica.executor, replica.store_executor, replica.wal_writer):
            stop = getattr(ex, "stop", None)
            if stop is not None:
                stop()
        storage.close()
        os.remove(path)  # the data file (sparse, production-sized); the trace stays


def _report(snap: dict, out, *, device, config, batches, batch, warmup,
            overlap, store_async, depth, wall_s, drain_s, seal_s, builds,
            native_bus) -> dict:
    """Print the tables and check the registry's invariants; returns the
    record."""
    assert snap.get("vsr.sheds", {}).get("count", 0) == 0, snap.get("vsr.sheds")
    total_ms = snap["server.total"]["total_ms"]
    assert abs(total_ms / 1e3 - wall_s) / wall_s < 0.05, (total_ms, wall_s)

    def span_ms(keys):
        return sum(snap[k]["total_ms"] for k in keys if k in snap)

    def span_pcts(keys):
        """(p50_us, p99_us) of the dominant (largest-total) event."""
        best = None
        for k in keys:
            rec = snap.get(k)
            if rec and "p50_us" in rec and (
                    best is None or rec["total_ms"] > best["total_ms"]):
                best = rec
        return (best["p50_us"], best["p99_us"]) if best else (0.0, 0.0)

    out(f"device={device} config={config} batches={batches} batch={batch} "
        f"overlap={overlap} store_async={store_async} warmup={warmup}"
        + (f" commit_depth={depth}" if overlap else ""))
    out(f"client seal:    {seal_s / (batches + warmup) * 1e3:.2f} ms/batch")
    out(f"server total:   {total_ms / batches:.2f} ms/batch "
        f"({batches * batch / (total_ms / 1e3):.0f} tx/s)")
    if store_async:
        out(f"store drain tail after last reply: {drain_s * 1e3:.2f} ms")

    stages = dict(STAGES)
    if store_async:
        stages["store.wait"] = ("sm.store.barrier",)
        stages["store.stall"] = ("pipeline.store.stall",)
    else:
        stages.update(STORE_ROWS)
    reply_ms = snap.get("stage.reply", {}).get("total_ms", 0.0)
    out("\nstage attribution (per batch; p50/p99 per span; builds = kernel "
        "libraries built inside the window):")
    out(f"  {'stage':12s} {'ms/batch':>9s} {'% wall':>7s} {'p50_us':>9s} "
        f"{'p99_us':>9s} {'builds':>7s}")
    rows = {}  # the stage rows (the reference's devhub `stages`)
    attributed = 0.0
    for stage, keys in stages.items():
        ms = span_ms(keys)
        if stage == "execute" and not overlap:
            ms -= reply_ms + span_ms(("sm.store.barrier",)) * store_async
        attributed += ms
        p50, p99 = span_pcts(keys)
        rows[stage] = round(ms / batches, 3)
        rows[f"{stage}_p99_us"] = p99
        n_b = builds if stage == "execute" else 0
        out(f"  {stage:12s} {ms / batches:9.2f} {100 * ms / total_ms:6.1f}% "
            f"{p50:9.1f} {p99:9.1f} {n_b:7d}")
    other = total_ms - attributed
    rows["other"] = round(other / batches, 3)
    out(f"  {'other':12s} {other / batches:9.2f} {100 * other / total_ms:6.1f}%")
    assert builds == 0, f"{builds} kernel build(s) inside the measured window"
    if not overlap:
        # Every commit-path row on the loop: disjoint rows cannot sum
        # past the window.
        assert attributed <= total_ms * 1.05, (attributed, total_ms)

    for title, table in (
        ("query-index pipeline (inside store.query and the flush)", QUERY_ROWS),
        ("streaming compaction (inside the beat row; the device fold "
         "overlaps the host build)", COMPACT_ROWS),
        ("native bus codec (inside the parse and reply rows)", BUS_ROWS),
    ):
        shown = {s: k for s, k in table.items() if span_ms(k)}
        if not shown or set(shown) == {"compact.beat"}:
            continue
        out(f"\n{title}:")
        out(f"  {'span':16s} {'ms/batch':>9s} {'p50_us':>9s} {'p99_us':>9s}")
        for stage, keys in shown.items():
            ms = span_ms(keys)
            p50, p99 = span_pcts(keys)
            rows[stage] = round(ms / batches, 3)
            out(f"  {stage:16s} {ms / batches:9.2f} {p50:9.1f} {p99:9.1f}")

    if overlap or store_async:
        out("\nworker threads (off the commit path; overlaps the wall time "
            "above):")
        out(f"  {'stage':12s} {'ms/batch':>9s} {'% wall':>7s} {'p50_us':>9s} "
            f"{'p99_us':>9s}")
        worker_rows = {"wal.write": ("wal.write",)}
        if store_async:
            worker_rows.update(STORE_ROWS)
            worker_rows["store.total"] = ("stage.store_async",)
        for stage, keys in worker_rows.items():
            ms = span_ms(keys)
            p50, p99 = span_pcts(keys)
            rows[f"async.{stage}"] = round(ms / batches, 3)
            out(f"  {stage:12s} {ms / batches:9.2f} {100 * ms / total_ms:6.1f}% "
                f"{p50:9.1f} {p99:9.1f}")
        window_ms = total_ms + drain_s * 1e3
        for group in (("wal.write",), ("stage.store_async",)):
            assert span_ms(group) <= window_ms * 1.05, (group, window_ms)

    stalls = {k: snap[k]["total_ms"] for k in STALL_ROWS if k in snap}
    if stalls:
        out("\nstage idle/stall (thread-seconds inside the window):")
        for k, ms in stalls.items():
            rows[k] = round(ms / batches, 3)
            out(f"  {k:22s} {ms / batches:9.2f} ms/batch")

    lifecycle = tracer.lifecycle_summary()
    comps = lifecycle["components"]
    if comps:
        out(f"\nper-op lifecycle decomposition ({lifecycle['ops']} ops, "
            f"window {lifecycle['window_s']:.2f}s):")
        out(f"  {'component':18s} {'ms/op':>9s} {'p50_ms':>9s} {'p99_ms':>9s} "
            f"{'occupancy':>10s}")
        for name, s in comps.items():
            occ = lifecycle["occupancy"].get(name, 0.0)
            out(f"  {name:18s} {s['mean_ms']:9.3f} {s['p50_ms']:9.3f} "
                f"{s['p99_ms']:9.3f} {occ:10.2f}")
        perceived = lifecycle["perceived"]
        if perceived.get("count"):
            out(f"  {'= perceived':18s} {perceived['mean_ms']:9.3f} "
                f"{perceived['p50_ms']:9.3f} {perceived['p99_ms']:9.3f} "
                f"{lifecycle['occupancy'].get('total', 0.0):10.2f}")
    flat = lifecycle["flat"]
    if overlap and "commit_inflight_mean" in flat:
        out(f"\npipeline occupancy (commit window, depth="
            f"{flat.get('commit_depth', 1.0):.0f}): in-flight mean "
            f"{flat['commit_inflight_mean']:.2f} max "
            f"{flat.get('commit_inflight_max', 0):.0f}")
        rows["commit_inflight_mean"] = flat["commit_inflight_mean"]

    dev_rows = {k: v for k, v in snap.items()
                if k.startswith("device.") and v.get("total_ms")
                and not k.startswith("device.xfer.")}
    if dev_rows:
        out("\ndevice windows (per entry; step = dispatch to finish):")
        out(f"  {'entry':40s} {'calls':>7s} {'ms/call':>9s} {'p50_us':>9s} "
            f"{'p99_us':>9s}")
        for k in sorted(dev_rows):
            r = dev_rows[k]
            out(f"  {k:40s} {r['count']:7d} "
                f"{r['total_ms'] / max(r['count'], 1):9.3f} "
                f"{r.get('p50_us', 0.0):9.1f} {r.get('p99_us', 0.0):9.1f}")
    cost_rows = devicestats.cost_table(snap)
    if cost_rows:
        out("\ndevice cost (COSTS bytes at the recorded shapes x measured "
            "ms/call; bound = bytes or operations at the card's peak):")
        out(f"  {'entry':28s} {'calls':>6s} {'ms/call':>9s} {'GB/s':>9s} "
            f"{'bound_ms':>9s} {'bound':>10s}")
        for r in cost_rows:
            def na(v, f="{:.4f}"):
                return f.format(v) if isinstance(v, (int, float)) else "-"
            out(f"  {r['entry']:28s} {r['calls']:6d} {na(r['ms_per_call']):>9s} "
                f"{na(r['achieved_gbps'], '{:.1f}'):>9s} "
                f"{na(r['bound_ms']):>9s} {r['bound']:>10s}")
        xfer = devicestats.xfer_summary(snap)
        rows["xfer"] = xfer
        out(f"  transfers: h2d p50 {xfer.get('h2d_gbps_p50', 0.0):.3f} GB/s, "
            f"d2h p50 {xfer.get('d2h_gbps_p50', 0.0):.3f} GB/s, bytes/transfer "
            f"{xfer.get('bytes_per_transfer', '-')}")
    mem = tracer.device_mem_totals()
    if mem.get("owners"):
        owners = ", ".join(f"{o}={b / 1e6:.1f}MB"
                           for o, b in sorted(mem["owners"].items()))
        out(f"  device mem: {owners}  high-water "
            f"{mem['high_water_bytes'] / 1e6:.1f}MB")
    # The reference's devhub record (its profile_e2e.py:643-660), and
    # this run's own facts beside it.
    return {
        "metric": "e2e_stage_profile_ms_per_batch",
        "value": round(total_ms / batches, 3),
        "unit": "ms/batch",
        "extra": {
            "device": device, "config": config, "batches": batches,
            "batch": batch, "overlap": overlap, "store_async": store_async,
            "commit_depth": depth, "native_bus": int(native_bus),
            "stages": rows, "lifecycle": flat,
        },
        "tx_per_s": round(batches * batch / (total_ms / 1e3), 1),
        "wall_s": round(wall_s, 4),
        "kernel_builds": builds,
    }


def _query_probe(sm, accounts: int, batch: int, out) -> dict:
    """A short post-window query probe over the committed transfers; the
    plan/scan/probe/gather spans nest inside sm.query."""
    qf = np.zeros(1, dtype=types.QUERY_FILTER_V2_DTYPE)
    rng = np.random.default_rng(11)
    q0 = tracer.snapshot()
    n_queries = 16
    for _ in range(n_queries):
        qf[0]["ledger"] = 1
        qf[0]["code"] = 7
        qf[0]["limit"] = batch
        qf[0]["debit_account_id_lo"] = int(rng.integers(1, accounts + 1))
        sm.query_transfers(qf[0])
    q1 = tracer.snapshot()

    def q_ms(key):
        return (q1.get(key, {}).get("total_ms", 0.0)
                - q0.get(key, {}).get("total_ms", 0.0))

    rec = {}
    if q_ms("sm.query"):
        out("\nquery engine (post-window probe; the rows nest inside "
            "sm.query):")
        out(f"  {'span':16s} {'ms/query':>9s}")
        for stage, key in (("query.total", "sm.query"),
                           ("query.plan", "sm.query.plan"),
                           ("query.scan", "sm.query.scan"),
                           ("query.probe", "sm.query.probe"),
                           ("query.gather", "sm.query.gather")):
            ms = q_ms(key)
            rec[stage] = round(ms / n_queries, 3)
            out(f"  {stage:16s} {ms / n_queries:9.3f}")
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m tigerbeetle_tpu_torch.profile_e2e",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--serial-commit", action="store_true",
                    help="commit on the loop (no CommitExecutor)")
    ap.add_argument("--serial-store", action="store_true",
                    help="store inline after each commit (no StoreExecutor)")
    ap.add_argument("--depth", type=int, default=0,
                    help="commit window depth (0: the state machine's default)")
    ap.add_argument("--config", default="production",
                    choices=["production", "development", "test_min"],
                    help="a smaller config cuts the stream to its accounts and batch size")
    ap.add_argument("--trace", default=None, help="where tracer.dump writes the trace")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    return run(device=args.device, batches=args.batches,
               overlap=not args.serial_commit, store_async=not args.serial_store,
               commit_depth=args.depth, config=args.config, trace_path=args.trace)


if __name__ == "__main__":
    main()
