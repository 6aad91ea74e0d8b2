#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and hold it to its references.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero and no phase's failure is
caught:

  1. Build: compile the four CUDA kernels (tigerbeetle_tpu_torch/csrc,
     one nvcc per source, all started together) and print the seconds.
  2. Kernels vs plain, at the main path's shapes (A = 2^20 accounts,
     n = 8192 events, k = 16384 / 8192 slot rows): each kernel must be
     byte-equal to its plain PyTorch version on the same inputs on the
     card. create_transfers_fast runs four batches: every ladder rung
     (bails), a clean post, and the post over a pending + posted overflow
     on an untouched row and on a touched row (each must bail). Per
     kernel: median time by CUDA events, the bound (bytes the function
     must move over 3.35 TB/s; integer operations over 67 TOP/s never
     dominate), the plain version's time and, where one exists, the
     PyTorch call computing the same function.
  3. Main path, BASELINE config 1: StateMachine(PRODUCTION) on CUDA,
     10,000 accounts, 64 batches of 8190 uniform simple transfers (over
     all accounts but the last two, which take the bail batch), a
     depth-2 split-phase window dispatched under sync-debug mode "error",
     and a batch that bails and rolls back. Every result and every
     account's lookup bytes equal the port's CPU run; the first two
     batches also equal the serial Oracle.
  4. Main path, BASELINE config 2: 1,000,000 accounts, 32 batches of 8190
     Zipf(1.1)-skewed transfers, the same window and bail; the 1,000
     hottest accounts' lookup bytes equal the CPU run's.

Kernel launch counts are reset to 0 just before each main-path run and
read just after; each kernel must have launched in each run. The last
lines are the kernels' JSON, the card's name and power limit, and
{"ok": true, "device": {...}}. Without CUDA (or without the repository
beside it) the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# 32-bit scalar rate: the H100 SXM data sheet's fp32 rate outside the tensor cores.
INT_OPS_PER_S = 67e12
A_MAX = 1 << 20  # PRODUCTION accounts_max
N = 8192  # 8190-event batches padded to the 8192 bucket
TX_BATCH = 8190

RESULTS = {}  # kernel name -> its JSON row


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, reps):
    """Device milliseconds per fn() call by CUDA events: the median over 3
    windows of `reps` back-to-back calls, each window queued behind a
    ~50 ms device sleep so that the host's launch overhead (argument
    checks, ctypes) does not show as device time. One warm-up first."""
    fn()
    torch.cuda.synchronize()
    windows = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # clock cycles: holds the stream
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        windows.append(start.elapsed_time(end) / reps)
    return float(np.median(windows))


def flat(x) -> list:
    """The tensors of a tensor, tuple or NamedTuple (LedgerState), in order."""
    if isinstance(x, tuple):
        return [t for y in x for t in flat(y)]
    return [x]


def max_abs_err(torch, what, got, want) -> int:
    """Largest |kernel − plain| over every output element, as unsigned
    integers (0 iff byte-equal); a nonzero error or a shape or dtype
    mismatch fails the run."""
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(flat(got), flat(want), strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise SystemExit(f"{what}: output {g.shape}/{g.dtype} vs plain {w.shape}/{w.dtype}")
        if w.dtype == torch.uint32:
            g, w = g.view(torch.int32).long() & 0xFFFFFFFF, w.view(torch.int32).long() & 0xFFFFFFFF
        if w.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    log(f"{what}: max_abs_err={err} ({'byte-equal' if err == 0 else 'DIFFERS'})")
    if err:
        raise SystemExit(f"{what} disagrees with its plain version")
    return err


# --- phase 2 inputs -------------------------------------------------------


def kernel_state(rng, C):
    a = A_MAX
    st = {f: np.zeros((a, 4), np.uint32) for f in C.BALANCE_FIELDS}
    for f in st:
        st[f][:, 0] = rng.integers(0, 1 << 32, a, dtype=np.uint64)
        st[f][:, 1] = rng.integers(0, 1 << 8, a)
    st["ledger"] = np.where(rng.random(a) < 0.01, 2, 1).astype(np.uint32)
    st["flags"] = np.zeros(a, np.uint32)
    return st


def kernel_batch(rng, C, ladder: bool):
    """n = 8192 staged events. The post batch: valid simple events, a
    quarter pending, a tenth on 16 hot slots (no bail). The ladder batch:
    every rung, NOT_FOUND slots, hot slots, and amounts near 2^128 (bail)."""
    n, a = N, A_MAX
    hot = rng.integers(0, a, 16)
    dr = rng.integers(0, a, n)
    cr = rng.integers(0, a, n)
    h = rng.random(n) < 0.1
    dr[h] = rng.choice(hot, int(h.sum()))
    cr[h] = rng.choice(hot, int(h.sum()))
    b = {
        "id": rng.integers(1, 1 << 32, (n, 4), dtype=np.uint64).astype(np.uint32),
        "dr_slot": dr.astype(np.int32), "cr_slot": cr.astype(np.int32),
        "amount": np.zeros((n, 4), np.uint32),
        "pending_id": np.zeros((n, 4), np.uint32),
        "timeout": np.zeros(n, np.uint32), "ledger": np.ones(n, np.uint32),
        "code": np.ones(n, np.uint32), "flags": np.zeros(n, np.uint32),
        "timestamp": np.stack([np.arange(1, n + 1), np.zeros(n)], 1).astype(np.uint32),
    }
    b["amount"][:, 0] = rng.integers(1, 1 << 32, n, dtype=np.uint64)
    pend = rng.random(n) < 0.25
    b["flags"][pend] = C.F_PENDING
    b["timeout"][pend] = 60
    host = np.zeros(n, np.uint32)
    if ladder:
        r = rng.integers(0, 16, n)
        b["flags"][r == 0] |= 1 << 9
        b["id"][r == 1] = 0
        b["id"][r == 2] = 0xFFFFFFFF
        b["pending_id"][r == 3, 2] = 9
        b["timeout"][r == 4] = 3
        b["flags"][r == 4] &= ~np.uint32(C.F_PENDING)
        b["amount"][r == 5] = 0
        b["ledger"][r == 6] = 0
        b["code"][r == 7] = 0
        b["dr_slot"][r == 8] = C.NOT_FOUND
        b["cr_slot"][r == 9] = C.NOT_FOUND
        b["ledger"][r == 10] = 2
        b["flags"][r == 11] |= C.F_PENDING
        b["timeout"][r == 11] = 0xFFFFFFFF
        b["timestamp"][r == 11] = 0xFFFFFFF0
        b["flags"][r == 12] |= C.F_LINKED
        b["amount"][r == 13, 3] = 0xFFFFFFF0  # near 2^128 on hot slots
        b["dr_slot"][r == 13] = hot[0]
        host[r == 14] = rng.choice([3, 8, 9, 10, 11, 12], int((r == 14).sum()))
    return b, host


def clone(C, state):
    return C.LedgerState(*(t.clone() for t in state))


def set_row(torch, table, slot, limbs):
    """table[slot] = limbs (four uint32 values), through an int32 view."""
    row = np.array(limbs, np.uint32).view(np.int32)
    table.view(torch.int32)[slot] = torch.from_numpy(row).to(table.device)


def phase_kernels(torch, C, rng, dev):
    a = A_MAX
    st_np = kernel_state(rng, C)
    state = C.state_from_reference(st_np, dev)
    table_bytes = 4 * a * 16

    # create_transfers_fast: the ladder batch (bail), the post batch, and
    # the post batch over two states whose only overflow is pending +
    # posted: on a row no event touches (the whole-table check), and on a
    # touched row where neither add overflows alone (2^127 + (2^127 - 1)
    # before posting, so only the check after posting sees it).
    def ctf_case(kind, st, b, host):
        got = C.create_transfers_fast(st, b, host)
        want = C.create_transfers_fast_plain(st, b, host)
        err = max_abs_err(torch, f"create_transfers_fast {kind} batch", got, want)
        codes = want[1].view(torch.int32)
        log(f"create_transfers_fast {kind} batch: bail={bool(want[2])} "
            f"codes={sorted(set(codes.cpu().tolist()))}")
        return err, bool(want[2]), codes

    b_np, host_np = kernel_batch(rng, C, True)
    b = C.TransferBatch(**{k: torch.from_numpy(v).to(dev) for k, v in b_np.items()})
    host = torch.from_numpy(host_np).to(dev)
    err, bail, codes = ctf_case("ladder", state, b, host)
    if not (bail and set(C.LADDER_CODES.values()) <= set(codes.cpu().tolist())):
        raise SystemExit("ladder batch did not reach every rung and bail")
    b_np, host_np = kernel_batch(rng, C, False)
    if (b_np["flags"] & ~np.uint32(C.F_PENDING)).any():
        raise SystemExit("post batch carries a flag the fast route does not take")
    b = C.TransferBatch(**{k: torch.from_numpy(v).to(dev) for k, v in b_np.items()})
    host = torch.from_numpy(host_np).to(dev)
    err, bail, codes = ctf_case("post", state, b, host)
    if bail:
        raise SystemExit("post batch bailed")
    n_ok = int((codes == 0).sum())
    used = set(b_np["dr_slot"].tolist()) | set(b_np["cr_slot"].tolist())
    untouched = next(s for s in range(a - 1, 0, -1) if s not in used)
    touched = int(b_np["dr_slot"][int(torch.nonzero(codes == 0)[0])])
    half = [0, 0, 0, 1 << 31]
    for kind, slot, posted in (
        ("untouched-overflow", untouched, half),
        ("touched-overflow", touched, [0xFFFFFFFF] * 3 + [(1 << 31) - 1]),
    ):
        st = clone(C, state)
        set_row(torch, st.debits_pending, slot, half)
        set_row(torch, st.debits_posted, slot, posted)
        err_k, bail, _ = ctf_case(kind, st, b, host)
        err = max(err, err_k)
        if not bail:
            raise SystemExit(f"{kind} batch did not bail")
        del st
    batch_bytes = sum(t.numel() * t.element_size() for t in b) + 4 * N
    ctf_bytes = 2 * table_bytes + batch_bytes + 2 * N * 4 + 4 * N + 1
    ctf_ops = 24 * a + 120 * N
    record(torch, "create_transfers_fast", "create_transfers_fast.cu", "tigerbeetle_tpu/ops/commit.py:313",
           lambda: C.create_transfers_fast(state, b, host),
           lambda: C.create_transfers_fast_plain(state, b, host),
           None, ctf_bytes, ctf_ops, err, n_ok=n_ok)

    # register_accounts: one create_accounts batch (k = 8192), 10% masked
    # out. In place: each side gets its own copy of the state. Timed calls
    # rewrite the same rows, so repeating them changes nothing.
    k = N
    slots = torch.from_numpy(rng.choice(a, k, replace=False).astype(np.int32)).to(dev)
    ledger = torch.from_numpy(rng.integers(1, 9, k).astype(np.uint32)).to(dev)
    flags = torch.from_numpy(rng.integers(0, 8, k).astype(np.uint32)).to(dev)
    mask = torch.from_numpy(rng.random(k) < 0.9).to(dev)
    err = max_abs_err(torch, "register_accounts",
                      C.register_accounts(clone(C, state), slots, ledger, flags, mask),
                      C.register_accounts_plain(clone(C, state), slots, ledger, flags, mask))
    k_in = int(mask.sum())
    m_slots = slots[mask].long()
    m_ledger, m_flags = ledger.view(torch.int32)[mask], flags.view(torch.int32)[mask]
    lib = lambda: (state.ledger.view(torch.int32).index_copy_(0, m_slots, m_ledger),
                   state.flags.view(torch.int32).index_copy_(0, m_slots, m_flags))
    record(torch, "register_accounts", "register_accounts.cu", "tigerbeetle_tpu/ops/commit.py:316",
           lambda: C.register_accounts(state, slots, ledger, flags, mask),
           lambda: C.register_accounts_plain(state, slots, ledger, flags, mask),
           lib, k * 13 + k_in * 8, 4 * k, err)

    # read_balances: one lookup / serial prefetch (k = 16384).
    k = 2 * N
    slots = torch.from_numpy(rng.integers(0, a, k).astype(np.int32)).to(dev)
    err = max_abs_err(torch, "read_balances", C.read_balances(state, slots),
                      C.read_balances_plain(state, slots))
    tables = [getattr(state, f).view(torch.int32) for f in C.BALANCE_FIELDS]
    record(torch, "read_balances", "read_balances.cu", "tigerbeetle_tpu/ops/commit.py:353",
           lambda: C.read_balances(state, slots),
           lambda: C.read_balances_plain(state, slots),
           lambda: [torch.index_select(t, 0, slots) for t in tables],
           k * 4 + 2 * 4 * k * 16, 8 * k, err)

    # write_balances: one serial writeback (k = 16384 distinct slots), in
    # place like register_accounts.
    slots = torch.from_numpy(rng.choice(a, k, replace=False).astype(np.int32)).to(dev)
    rows = [torch.from_numpy(rng.integers(0, 1 << 32, (k, 4), dtype=np.uint64)
                             .astype(np.uint32)).to(dev) for _ in range(4)]
    err = max_abs_err(torch, "write_balances",
                      C.write_balances(clone(C, state), slots, *rows),
                      C.write_balances_plain(clone(C, state), slots, *rows))
    s_long = slots.long()
    rows32 = [r.view(torch.int32) for r in rows]
    lib = lambda: [t.index_copy_(0, s_long, r) for t, r in zip(tables, rows32)]
    record(torch, "write_balances", "write_balances.cu", "tigerbeetle_tpu/ops/commit.py:334",
           lambda: C.write_balances(state, slots, *rows),
           lambda: C.write_balances_plain(state, slots, *rows),
           lib, k * (4 + 64 + 64), 8 * k, err)


def record(torch, name, source, replaces, kernel, plain, library, nbytes, ops, err, **extra):
    ms = cuda_ms(torch, kernel, 10)
    plain_ms = cuda_ms(torch, plain, 2)
    library_ms = cuda_ms(torch, library, 10) if library is not None else None
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT_OPS_PER_S * 1e3
    RESULTS[name] = {
        "name": name, "route": "cuda",
        "source": f"tigerbeetle_tpu_torch/csrc/{source}", "replaces": replaces,
        "launches": 0, "max_abs_err": err, "parity": "byte-equal",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms, "bound_bytes": nbytes, **extra,
    }
    log(f"{name}: kernel {ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
        f"({nbytes} bytes), plain {plain_ms:.4f} ms, library "
        f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}")


# --- phases 3 and 4 -------------------------------------------------------


def account_batches(types, n_accounts, start=1):
    for lo in range(0, n_accounts, TX_BATCH):
        ids = np.arange(start + lo, start + min(lo + TX_BATCH, n_accounts), dtype=np.uint64)
        ev = np.zeros(len(ids), dtype=types.ACCOUNT_DTYPE)
        ev["id_lo"] = ids
        ev["ledger"] = 1
        ev["code"] = 10
        yield ev


def transfer_batch(types, first_id, dr, cr, amount_lo, amount_hi=None):
    n = len(dr)
    ev = np.zeros(n, dtype=types.TRANSFER_DTYPE)
    ev["id_lo"] = np.arange(first_id, first_id + n, dtype=np.uint64)
    ev["debit_account_id_lo"] = dr
    ev["credit_account_id_lo"] = cr
    ev["amount_lo"] = amount_lo
    if amount_hi is not None:
        ev["amount_hi"] = amount_hi
    ev["ledger"] = 1
    ev["code"] = 7
    return ev


def expect_equal(got, want, what):
    if got.tobytes() != want.tobytes():
        raise SystemExit(f"{what}: the CUDA run and the CPU run differ")


def run_config(torch, name, n_accounts, n_batches, pick, rng, check_ids, oracle_batches):
    from tigerbeetle_tpu_torch import tracer, types
    from tigerbeetle_tpu_torch.constants import PRODUCTION
    from tigerbeetle_tpu_torch.models.oracle import (
        Oracle, account_from_numpy, transfer_from_numpy,
    )
    from tigerbeetle_tpu_torch.models.state_machine import StateMachine
    from tigerbeetle_tpu_torch.ops import commit as C

    C.reset_launches()
    tracer.reset()
    gpu = StateMachine(PRODUCTION)  # CUDA, the default
    cpu = StateMachine(PRODUCTION, device="cpu")
    orc = Oracle() if oracle_batches else None
    # The last two accounts take the bail batch; `pick` draws the traffic
    # from the others.
    bail_ids = (n_accounts - 1, n_accounts)
    create_s = 0.0  # the CUDA machine's create_accounts calls
    for ev in account_batches(types, n_accounts):
        t = time.perf_counter()
        got = gpu.create_accounts(ev)
        torch.cuda.synchronize()
        create_s += time.perf_counter() - t
        expect_equal(got, cpu.create_accounts(ev), f"{name} create_accounts")
        if orc is not None:
            orc.create_accounts([account_from_numpy(r) for r in ev],
                                orc.prepare("create_accounts", len(ev)))

    next_id = 1 << 40
    lat = []
    for i in range(n_batches):
        dr, cr = pick(rng, TX_BATCH)
        ev = transfer_batch(types, next_id, dr + 1, cr + 1, rng.integers(1, 1 << 20, TX_BATCH))
        next_id += TX_BATCH
        tracer.enable()  # the CUDA machine's batches only: ~µs per span
        t = time.perf_counter()
        got = gpu.create_transfers(ev)
        lat.append(time.perf_counter() - t)
        tracer.disable()
        expect_equal(got, cpu.create_transfers(ev), f"{name} batch {i}")
        if i < oracle_batches:
            pairs = orc.create_transfers([transfer_from_numpy(r) for r in ev],
                                         orc.prepare("create_transfers", len(ev)))
            want = np.array(pairs, dtype=np.uint32).reshape(-1, 2)
            if not (np.array_equal(got["index"], want[:, 0]) and np.array_equal(got["result"], want[:, 1])):
                raise SystemExit(f"{name} batch {i}: differs from the serial Oracle")
    # Depth-2 split-phase window: both dispatches before either finish, and
    # neither dispatch may synchronise with the device.
    window = []
    for _ in range(2):
        dr, cr = pick(rng, TX_BATCH)
        window.append(transfer_batch(types, next_id, dr + 1, cr + 1, rng.integers(1, 1 << 20, TX_BATCH)))
        next_id += TX_BATCH
    results = {}
    for sm in (gpu, cpu):
        stamps = [sm.prepare("create_transfers", TX_BATCH) for _ in window]
        if sm is gpu:
            torch.cuda.set_sync_debug_mode("error")
        try:
            handles = [sm.create_transfers_dispatch(ev, ts) for ev, ts in zip(window, stamps)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if any(h is None for h in handles):
            raise SystemExit(f"{name}: a window batch was not dispatched")
        results[sm] = [sm.create_transfers_finish(h) for h in handles]
    for g, c in zip(results[gpu], results[cpu]):
        expect_equal(g, c, f"{name} window")
    # A batch that bails inside a window: amounts near 2^128 on two accounts.
    k = 64
    bail_ev = transfer_batch(
        types, next_id, np.full(k, bail_ids[0]), np.full(k, bail_ids[1]),
        rng.integers(1, 1 << 60, k, dtype=np.uint64), np.full(k, (1 << 64) - 2, np.uint64),
    )
    for sm in (gpu, cpu):
        ts = sm.prepare("create_transfers", k)
        h = sm.create_transfers_dispatch(bail_ev, ts)
        if h is None:
            raise SystemExit(f"{name}: the bail batch was not dispatched")
        results[sm] = sm.create_transfers_finish(h)
    expect_equal(results[gpu], results[cpu], f"{name} bail batch")
    if gpu.stats["bail_batches"] != 1 or len(results[gpu]) != k - 1:
        raise SystemExit(f"{name}: the bail batch did not bail and re-run serially")
    # Lookups (read_balances) on the card against the CPU run.
    ids = np.asarray(check_ids, dtype=np.uint64)
    for lo in range(0, len(ids), TX_BATCH):
        part = ids[lo:lo + TX_BATCH]
        zero = np.zeros(len(part), np.uint64)
        expect_equal(gpu.lookup_accounts(part, zero), cpu.lookup_accounts(part, zero), f"{name} lookup")
    bail_acc = gpu.lookup_accounts(np.array(bail_ids, np.uint64), np.zeros(2, np.uint64))
    expect_equal(bail_acc, cpu.lookup_accounts(np.array(bail_ids, np.uint64), np.zeros(2, np.uint64)), f"{name} bail accounts")
    torch.cuda.synchronize()
    launches = dict(C.LAUNCHES)
    stats = dict(gpu.stats)
    snap = tracer.snapshot()
    if stats["fast_batches"] < n_batches or min(launches.values()) == 0:
        raise SystemExit(f"{name}: stats {stats}, launches {launches}")
    lat_ms = np.array(lat[1:]) * 1e3  # the first batch pays one-time setup
    tps = TX_BATCH * len(lat_ms) / (lat_ms.sum() / 1e3)
    log(f"{name}: accounts={n_accounts} create_accounts_s={create_s:.3f} "
        f"batches={n_batches} timed={len(lat_ms)} transfers_per_s={tps:.0f} "
        f"batch_p50_ms={np.percentile(lat_ms, 50):.3f} "
        f"batch_p99_ms={np.percentile(lat_ms, 99):.3f} "
        f"batch_max_ms={lat_ms.max():.3f} stats={stats} launches={launches}")
    # Where a batch's time goes (the CUDA machine's traffic batches;
    # device.step.* are CUDA-event windows from dispatch to finish).
    log(f"{name}: batch latencies ms " + json.dumps([round(x * 1e3, 2) for x in lat]))
    top = sorted(snap.items(), key=lambda kv: -kv[1]["total_ms"])[:16]
    log(f"{name} spans: " + json.dumps({
        k: {"count": v["count"], "total_ms": round(v["total_ms"], 3), "max_ms": round(v["max_us"] / 1e3, 3)}
        for k, v in top
    }))
    win = snap.get("device.step.create_transfers_fast", {"total_ms": 0.0, "count": 0})
    log(f"{name}: create_transfers_fast dispatch-to-finish windows {win['count']}, "
        f"mean {win['total_ms'] / max(win['count'], 1):.4f} ms")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20261017)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from tigerbeetle_tpu_torch import native
    from tigerbeetle_tpu_torch.ops import commit as C
    from tigerbeetle_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    kernels.build_all()
    log(f"phase 1: built {len(kernels.SIGNATURES)} kernels in {time.perf_counter() - t0:.2f} s")
    # The C host shims (staging, hash map, block checksum) build at first
    # use too: build them here, outside the timed batches.
    t0 = time.perf_counter()
    if native.hostops() is None:
        raise SystemExit("the C staging shim (csrc/hostops.c) did not build")
    native.aegis128l_mac()  # None: no AES-NI, blocks use BLAKE2b instead
    log(f"phase 1: built the C host shims in {time.perf_counter() - t0:.2f} s")
    for name, out in kernels.BUILD_LOG.items():  # ptxas: registers, spills
        for line in out.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    rng = np.random.default_rng(args.seed)
    log("phase 2: kernels vs plain versions at A=2^20, n=8192")
    phase_kernels(torch, C, rng, dev)

    log("phase 3: BASELINE config 1 (10,000 accounts, uniform)")
    n1 = 10_000
    t1 = n1 - 2  # traffic accounts (the last two take the bail batch)
    uniform = lambda r, n: distinct_pair(r.integers(0, t1, n), r.integers(0, t1, n), t1)
    l1 = run_config(torch, "config1", n1, 64, uniform, rng, np.arange(1, n1 + 1), 2)

    log("phase 4: BASELINE config 2 (1,000,000 accounts, Zipf(1.1))")
    n2 = 1_000_000
    t2 = n2 - 2
    cdf = np.cumsum(np.arange(1, t2 + 1, dtype=np.float64) ** -1.1)  # rank 1 hottest
    cdf /= cdf[-1]

    def zipf(r, n):
        draw = lambda: np.minimum(np.searchsorted(cdf, r.random(n)), t2 - 1)
        return distinct_pair(draw(), draw(), t2)

    l2 = run_config(torch, "config2", n2, 32, zipf, rng, np.arange(1, 1001), 0)

    for name, row in RESULTS.items():
        row["launches"] = l1[name]
        row["launches_config2"] = l2[name]
    print(json.dumps({"kernels": list(RESULTS.values())}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def distinct_pair(dr, cr, n):
    """Debit/credit account indices, never the same account."""
    return dr, np.where(cr == dr, (cr + 1) % n, cr)


if __name__ == "__main__":
    sys.exit(main())
