"""Component fuzzer registry (reference src/fuzz_tests.zig:24-40).

Each fuzzer drives one component against a trivial in-memory model with
seeded random operations and injected faults:

    python -m tigerbeetle_tpu_torch.fuzz <name> --seed N [--iters K]
    python -m tigerbeetle_tpu_torch.fuzz --list

Registered fuzzers (reference analogs):
    lsm_tree       DurableIndex insert/lookup/scan/compact vs dict model
                   (lsm_tree_fuzz.zig / lsm_forest_fuzz.zig)
    lsm_log        DurableLog append/gather/scan + checkpoint/restore vs
                   list model
    grid_free_set  FreeSet acquire/stage/commit/encode + crash-rewind
                   over MemStorage (vsr_free_set_fuzz.zig)
    ewah           EWAH codec round-trips incl. truncation robustness
                   (ewah_fuzz.zig)
    journal        WAL write/torn-crash/recover classification
                   (vsr_journal_format_fuzz.zig)

The superblock torn-write fuzzer lives in
tests/test_torch_superblock_fuzz.py; tests/test_torch_fuzz.py smoke-runs
this registry. Every component here is host code: no fuzzer launches a
kernel.
"""

from __future__ import annotations

import argparse
import random
import sys
from typing import Callable, Dict

import numpy as np


def fuzz_lsm_tree(seed: int, iters: int) -> None:
    """DurableIndex vs a dict model: random unique inserts, batch lookups,
    non-unique range reads, compaction beats, checkpoint/restore."""
    from tigerbeetle_tpu_torch.io.grid import MemGrid
    from tigerbeetle_tpu_torch.lsm.store import NOT_FOUND, pack_keys
    from tigerbeetle_tpu_torch.lsm.tree import DEFAULT_COMPACT_QUOTA, DurableIndex

    rng = np.random.default_rng(seed)
    py = random.Random(seed)
    grid = MemGrid(1 << 12, 1 << 12)
    unique = py.random() < 0.5
    tree = DurableIndex(grid, unique=unique, memtable_max=256)
    model: Dict[int, list] = {}
    next_val = 0

    def key_int(k) -> int:
        return int(k["lo"]) | (int(k["hi"]) << 64)

    for it in range(iters):
        op = py.random()
        if op < 0.55:
            n = py.randint(1, 96)
            if unique:
                # Unique index: mint fresh keys only.
                lo = np.arange(next_val + 1, next_val + n + 1, dtype=np.uint64)
                hi = rng.integers(0, 4, n, dtype=np.uint64)
            else:
                lo = rng.integers(0, 64, n, dtype=np.uint64)
                hi = np.zeros(n, dtype=np.uint64)
            keys = pack_keys(lo, hi)
            vals = np.arange(next_val, next_val + n, dtype=np.uint32)
            next_val += n
            tree.insert_batch(keys, vals)
            for k, v in zip(keys, vals):
                model.setdefault(key_int(k), []).append(int(v))
        elif op < 0.8:
            # Lookup a mix of present and absent keys.
            present = py.sample(list(model), min(len(model), 32)) if model else []
            absent = [py.getrandbits(80) | (1 << 79) for _ in range(8)]
            probe = present + absent
            if not probe:
                continue
            keys = pack_keys(
                np.array([k & ((1 << 64) - 1) for k in probe], dtype=np.uint64),
                np.array([k >> 64 for k in probe], dtype=np.uint64),
            )
            got = tree.lookup_batch(keys)
            for k, g in zip(probe, got):
                want = model.get(k)
                if want is None:
                    assert g == NOT_FOUND, (seed, it, k, int(g))
                elif unique:
                    assert int(g) == want[0], (seed, it, k, int(g), want)
                else:
                    assert int(g) in want, (seed, it, k, int(g), want)
        elif op < 0.9 and not unique and model:
            k = py.choice(list(model))
            got = tree.lookup_range(
                pack_keys(
                    np.array([k & ((1 << 64) - 1)], dtype=np.uint64),
                    np.array([k >> 64], dtype=np.uint64),
                )[0]
            )
            assert sorted(got.tolist()) == sorted(model[k]), (seed, it, k)
        else:
            tree.compact_step(DEFAULT_COMPACT_QUOTA)
            if py.random() < 0.3:
                # Checkpoint + restore into a fresh tree over the same grid.
                manifest = tree.checkpoint()
                fences, counts = tree.checkpoint_fences()
                t2 = DurableIndex(grid, unique=unique, memtable_max=256)
                t2.restore(manifest)
                t2.attach_fences(fences, counts)
                tree = t2
    print(f"lsm_tree seed={seed}: {iters} ops, {len(model)} keys, "
          f"{sum(len(t) for t in tree.levels)} tables OK")


def fuzz_lsm_log(seed: int, iters: int) -> None:
    """DurableLog vs a list model: appends with ts overrides, gathers,
    range scans, flush pacing, checkpoint/restore."""
    from tigerbeetle_tpu_torch.io.grid import MemGrid
    from tigerbeetle_tpu_torch.lsm.log import DurableLog

    dtype = np.dtype([("timestamp", "<u8"), ("x", "<u8")])
    rng = np.random.default_rng(seed)
    py = random.Random(seed)
    grid = MemGrid(1 << 12, 1 << 12)
    log = DurableLog(grid, dtype)
    model: list = []

    for it in range(iters):
        op = py.random()
        if op < 0.5:
            n = py.randint(1, 600)
            recs = np.zeros(n, dtype=dtype)
            recs["x"] = rng.integers(0, 1 << 62, n, dtype=np.uint64)
            ts = np.arange(len(model) + 1, len(model) + n + 1, dtype=np.uint64)
            rows = log.append_batch(recs, ts=ts)
            assert rows[0] == len(model) if n else True
            recs2 = recs.copy()
            recs2["timestamp"] = ts
            model.extend(recs2.tolist())
            if py.random() < 0.5:
                log.flush_pending(py.randint(1, 4))
        elif op < 0.8 and model:
            rows = rng.integers(0, len(model), py.randint(1, 64))
            got = log.gather(rows)
            for r, g in zip(rows, got):
                assert tuple(g) == model[int(r)], (seed, it, int(r))
        elif op < 0.9 and model:
            a = py.randint(0, len(model))
            b = py.randint(a, len(model))
            pieces = [w for _b, w in log.scan_range(a, b)]
            got = np.concatenate(pieces) if pieces else np.zeros(0, dtype=dtype)
            assert got.tolist() == [tuple(m) for m in model[a:b]], (seed, it)
        else:
            blocks, tail = log.checkpoint()
            l2 = DurableLog(grid, dtype)
            l2.restore(blocks, tail)
            assert l2.count == log.count
            log = l2
    print(f"lsm_log seed={seed}: {iters} ops, {len(model)} rows OK")


def fuzz_grid_free_set(seed: int, iters: int) -> None:
    """FreeSet + grid over MemStorage: acquire/write/release/stage/commit
    with EWAH encode/restore round-trips and crash-rewind (unsynced
    acquisitions must roll back to the last encoded state)."""
    from tigerbeetle_tpu_torch.io import ewah
    from tigerbeetle_tpu_torch.io.grid import Grid
    from tigerbeetle_tpu_torch.io.storage import MemStorage

    py = random.Random(seed)
    block_size = 1 << 12
    block_count = 256
    storage = MemStorage(block_count * block_size, seed=seed)
    grid = Grid(storage, 0, block_count, block_size, defer_releases=True)
    live: Dict[int, bytes] = {}  # block -> payload (the model)
    checkpointed = None  # (encoded free set, live snapshot)

    for it in range(iters):
        op = py.random()
        if op < 0.5 and grid.free_set.free_count > 8:
            payload = py.randbytes(py.randint(1, block_size - 64))
            b = grid.write_block(payload, block_type=1)
            assert b not in live
            live[b] = payload
        elif op < 0.65 and live:
            b = py.choice(list(live))
            grid.release(b)  # staged: stays readable until commit
            del live[b]
        elif op < 0.8 and live:
            b = py.choice(list(live))
            assert grid.read_block(b) == live[b], (seed, it, b)
        elif op < 0.9:
            # Checkpoint: encode the free set; staged releases apply.
            enc = grid.free_set.encode()
            storage.sync()
            grid.commit_releases()
            checkpointed = (enc, dict(live))
            # Round-trip the encoding against the live bitset.
            words = ewah.decode(enc, -(-block_count // ewah.WORD_BITS))
            bits = ewah.words_to_bitset(words, block_count)
            assert np.array_equal(bits, grid.free_set.free), (seed, it)
        elif checkpointed is not None:
            # Crash: lose unsynced writes; restore the free set from the
            # last checkpoint encoding. Blocks acquired since are free
            # again; checkpointed blocks must survive with their bytes.
            storage.crash(torn_write_probability=0.5)
            enc, snap = checkpointed
            grid.free_set.restore(enc)
            grid.drop_cache()
            live = dict(snap)
            for b, payload in live.items():
                assert grid.read_block(b) == payload, (seed, it, b)
    print(f"grid_free_set seed={seed}: {iters} ops, {len(live)} live blocks OK")


def fuzz_ewah(seed: int, iters: int) -> None:
    """EWAH codec: random (runny and noisy) bitsets round-trip exactly;
    truncated encodings must raise, never mis-decode silently."""
    from tigerbeetle_tpu_torch.io import ewah

    rng = np.random.default_rng(seed)
    py = random.Random(seed)
    for it in range(iters):
        n = py.randint(1, 1 << 14)
        style = py.random()
        if style < 0.4:  # long runs (the EWAH sweet spot)
            bits = np.zeros(n, dtype=bool)
            pos = 0
            while pos < n:
                ln = py.randint(1, n)
                val = py.random() < 0.5
                bits[pos : pos + ln] = val
                pos += ln
        else:  # noise
            bits = rng.random(n) < py.choice([0.02, 0.5, 0.98])
        words = ewah.bitset_to_words(bits)
        enc = ewah.encode(words)
        dec = ewah.decode(enc, len(words))
        assert np.array_equal(ewah.words_to_bitset(dec, n), bits), (seed, it)
        if len(enc) > 8 and py.random() < 0.3:
            cut = py.randrange(0, len(enc) - 1)
            try:
                got = ewah.decode(enc[:cut], len(words))
                # A tolerant decode must still never return WRONG words
                # for the prefix it claims to have decoded.
                assert len(got) <= len(words)
            except Exception:
                pass  # raising on truncation is the expected behavior
    print(f"ewah seed={seed}: {iters} round-trips OK")


def fuzz_journal(seed: int, iters: int) -> None:
    """Journal write/crash/recover: after a torn crash, every slot the
    recovery reports as valid must hold exactly the bytes written, and
    every synced (durable) prepare must survive."""
    from tigerbeetle_tpu_torch.constants import config_by_name
    from tigerbeetle_tpu_torch.io.storage import MemStorage, Zone
    from tigerbeetle_tpu_torch.vsr import header as hdr
    from tigerbeetle_tpu_torch.vsr.header import Command, Message
    from tigerbeetle_tpu_torch.vsr.journal import Journal

    py = random.Random(seed)
    config = config_by_name("test_min")
    zone = Zone.for_config(config.journal_slot_count, config.message_size_max)
    storage = MemStorage(zone.total_size, seed=seed)
    journal = Journal(storage, zone, config.journal_slot_count, config.message_size_max)
    durable: Dict[int, bytes] = {}  # op -> body (synced writes only)
    op = 0

    for it in range(iters):
        r = py.random()
        if r < 0.6:
            op += 1
            body = py.randbytes(py.randint(0, 1024))
            ph = hdr.make(
                Command.PREPARE, 0, op=op, view=1,
                timestamp=op * 10, operation=128,
            )
            msg = Message(ph, body).seal()
            sync = py.random() < 0.7
            journal.write_prepare(msg, sync=sync)
            if sync:
                # fsync barrier covers everything buffered before it.
                durable = {
                    o: b for o, b in {**durable, op: body}.items()
                    if o > op - config.journal_slot_count
                }
                durable[op] = body
        elif r < 0.8 and op:
            probe = py.randint(max(1, op - config.journal_slot_count + 1), op)
            m = journal.read_prepare(probe)
            if m is not None:
                assert m.header["op"] == probe
        else:
            storage.crash(torn_write_probability=py.choice([0.0, 0.5, 1.0]))
            journal.recover(0)
            journal.flush_dirty()
            for o, body in durable.items():
                if o <= op - config.journal_slot_count:
                    continue  # slot reused since
                slot = journal.slot_for_op(o)
                h = journal.headers.get(slot)
                if h is not None and h["op"] > o:
                    continue  # overwritten by a newer unsynced op that survived
                m = journal.read_prepare(o)
                assert m is not None and m.body == body, (
                    seed, it, o, "durable prepare lost"
                )
            # Rebuild the model from what recovery reports (crash dropped
            # an unknown subset of unsynced writes).
            durable = {}
            for slot, h in journal.headers.items():
                if slot in journal.faulty:
                    continue
                m = journal.read_prepare(int(h["op"]))
                if m is not None:
                    durable[int(h["op"])] = m.body
            storage.sync()
    print(f"journal seed={seed}: {iters} ops, high op {op} OK")


REGISTRY: Dict[str, Callable[[int, int], None]] = {
    "lsm_tree": fuzz_lsm_tree,
    "lsm_log": fuzz_lsm_log,
    "grid_free_set": fuzz_grid_free_set,
    "ewah": fuzz_ewah,
    "journal": fuzz_journal,
}

DEFAULT_ITERS = {
    "lsm_tree": 400, "lsm_log": 300, "grid_free_set": 600,
    "ewah": 200, "journal": 500,
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tigerbeetle_tpu_torch.fuzz")
    p.add_argument("name", nargs="?", choices=sorted(REGISTRY), default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seeds", type=int, default=1, help="run seed..seed+N-1")
    p.add_argument("--iters", type=int, default=0)
    p.add_argument("--list", action="store_true")
    args = p.parse_args(argv)
    if args.list or args.name is None:
        for name in sorted(REGISTRY):
            print(name)
        return 0
    iters = args.iters or DEFAULT_ITERS[args.name]
    for seed in range(args.seed, args.seed + args.seeds):
        REGISTRY[args.name](seed, iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
