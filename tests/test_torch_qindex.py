"""The port's query-index pipeline (tigerbeetle_tpu_torch/ops/qindex.py and
the lazy device runs of lsm/tree.py) against the reference package's, on
the CPU.

The same numpy batches, made from a seed, go through the JAX key build
(jit on the CPU) and the port's plain versions; keys and payloads must be
byte-equal. The lazy-run tier (flush cadence, the device fold, reads that
resolve runs, the idle prefetch) is driven through the port's DurableIndex
against the reference's with TIGERBEETLE_TPU_DEVICE_MERGE=1 (set for the
reference side only: the port reads no environment variable), comparing
table bytes. The slice as a whole: the port's StateMachine(device="cpu",
device_query_index=True) against the reference StateMachine(backend="jax")
on one op stream, comparing query results and the query tree's tables.
"""

import threading

import numpy as np
import pytest
import torch

from tigerbeetle_tpu import types as ref_types
from tigerbeetle_tpu.constants import Config
from tigerbeetle_tpu.io.grid import MemGrid as RefGrid
from tigerbeetle_tpu.lsm.tree import DurableIndex as RefIndex
from tigerbeetle_tpu.models.state_machine import StateMachine as RefSM
from tigerbeetle_tpu.ops import qindex as ref_qindex
from tigerbeetle_tpu_torch.io.grid import MemGrid
from tigerbeetle_tpu_torch.lsm import scan
from tigerbeetle_tpu_torch.lsm import tree as port_tree
from tigerbeetle_tpu_torch.lsm.store import KEY_DTYPE
from tigerbeetle_tpu_torch.lsm.tree import DurableIndex
from tigerbeetle_tpu_torch.models.state_machine import StateMachine as PortSM
from tigerbeetle_tpu_torch.ops import qindex

from exact_batches import SORT_EDGES, sort_block

CPU = torch.device("cpu")


def rand_recs(rng, n, constant=False):
    recs = np.zeros(n, dtype=ref_types.TRANSFER_DTYPE)
    if constant:
        recs["ledger"] = 1
        recs["code"] = 7
    else:
        recs["user_data_128_lo"] = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        recs["user_data_128_hi"] = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        recs["user_data_64"] = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        recs["user_data_32"] = rng.integers(0, 1 << 32, n, dtype=np.uint32)
        recs["ledger"] = rng.integers(1, 5, n)
        recs["code"] = rng.integers(1, 5, n)
    recs["timestamp"] = rng.integers(1, 1 << 63, n, dtype=np.uint64)
    return recs


def edge_recs():
    """fold56 edge values: every queryable field straddling 2^56 and at
    2^63 and 2^64 - 1, u128 hi words at the 55/56-bit fold boundaries."""
    edges = np.array(
        [0, 1, (1 << 56) - 1, 1 << 56, (1 << 56) + 1, 1 << 63, (1 << 64) - 1,
         (1 << 57) - 1], dtype=np.uint64,
    )
    n = len(edges)
    recs = np.zeros(n, dtype=ref_types.TRANSFER_DTYPE)
    recs["user_data_64"] = edges
    recs["user_data_128_lo"] = edges[::-1].copy()
    recs["user_data_128_hi"] = np.array(
        [0, 1, (1 << 55) - 1, 1 << 55, (1 << 56) - 1, 1 << 56, (1 << 64) - 1,
         (1 << 23) + 1], dtype=np.uint64,
    )
    recs["user_data_32"] = np.uint32((1 << 32) - 1)
    recs["ledger"] = np.uint32((1 << 32) - 1)
    recs["code"] = np.uint16((1 << 16) - 1)
    recs["timestamp"] = np.arange(1, n + 1, dtype=np.uint64) << np.uint64(40)
    return recs


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _same(got, want):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape
    assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("variant", ["query_index_keys", "query_index_keys_sorted"])
@pytest.mark.parametrize("n", [1, 255, 300, 8190])
def test_key_build_matches_reference(n, variant):
    rng = np.random.default_rng(n)
    recs = rand_recs(rng, n)
    recs[: min(n, 8)] = edge_recs()[: min(n, 8)]
    rows = rng.integers(0, 1 << 32, n).astype(np.uint32)
    staged = qindex.stage_query_batch(recs, rows, recs["timestamp"])
    for got, want in zip(staged, ref_qindex.stage_query_batch(recs, rows, recs["timestamp"])):
        _same(got, want)
    pk, pp = getattr(qindex, variant)(*_t(staged))
    rk, rp = getattr(ref_qindex, variant)(*staged)
    _same(pk, rk)
    _same(pp, rp)


def test_fold56_boundary_values_match_host_fold():
    """The plain build's key.lo equals lsm/scan.fold56 on the host for
    every edge value."""
    from tigerbeetle_tpu_torch.ops.merge import to_host_kv

    recs = edge_recs()
    rows = np.arange(len(recs), dtype=np.uint32)
    staged = _t(qindex.stage_query_batch(recs, rows, recs["timestamp"]))
    n = len(recs)
    n_pad = staged[2].shape[0]
    k, p = qindex.query_index_keys(*staged)
    keys, vals = to_host_kv(k, p, 5 * n_pad)
    keep = np.concatenate([np.arange(b * n_pad, b * n_pad + n) for b in range(5)])
    keys, vals = keys[keep], vals[keep]
    for b, (tag, f_lo, f_hi) in enumerate(scan.QUERY_TAG_FIELDS):
        folded = scan.fold56(recs[f_lo], recs[f_hi] if f_hi else None)
        want = (np.uint64(tag) << np.uint64(56)) | folded
        assert np.array_equal(keys["lo"][b * n:(b + 1) * n], want)
        assert np.array_equal(keys["hi"][b * n:(b + 1) * n], recs["timestamp"])
        assert np.array_equal(vals[b * n:(b + 1) * n], rows)


@pytest.mark.parametrize("seed,n", [(1, 1), (2, 255), (3, 1000), (4, 8190)])
def test_build_run_materialize_matches_reference(seed, n, monkeypatch):
    monkeypatch.setenv("TIGERBEETLE_TPU_DEVICE_MERGE", "1")
    rng = np.random.default_rng(seed)
    recs = rand_recs(rng, n, constant=seed == 2)
    rows = rng.integers(0, 1 << 32, n).astype(np.uint32)
    run = qindex.build_run(recs, rows, recs["timestamp"], CPU)
    ref = ref_qindex.build_run(recs, rows, recs["timestamp"])
    assert run.n == ref.n == 5 * n
    assert run.sorted == ref.sorted
    pk, pv = run.materialize()
    rk, rv = ref.materialize()
    assert pk.tobytes() == rk.tobytes()
    assert np.array_equal(pv, rv)


def test_materialize_idempotent_and_threadsafe():
    rng = np.random.default_rng(9)
    recs = rand_recs(rng, 300)
    run = qindex.build_run(recs, np.arange(300, dtype=np.uint32), recs["timestamp"], CPU)
    got = []
    threads = [threading.Thread(target=lambda: got.append(run.materialize())) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 4 and all(g is got[0] for g in got)
    assert run.materialized
    assert run.materialize() is got[0]


def test_fold_runs_device_matches_reference(monkeypatch):
    """Four sorted runs (one with top-bit user data, one constant) folded
    oldest first, against the reference fold on the same batches."""
    monkeypatch.setenv("TIGERBEETLE_TPU_DEVICE_MERGE", "1")
    rng = np.random.default_rng(21)
    port_runs, ref_runs = [], []
    row0 = 0
    for i, n in enumerate((300, 1, 137, 256)):
        recs = rand_recs(rng, n, constant=i == 1)
        if i == 2:
            recs["user_data_64"] |= np.uint64(1 << 63)
        rows = np.arange(row0, row0 + n, dtype=np.uint32)
        row0 += n
        port_runs.append(qindex.build_run(recs, rows, recs["timestamp"], CPU))
        ref_runs.append(ref_qindex.build_run(recs, rows, recs["timestamp"]))
    kd, pd, n_real = qindex.fold_runs_device(port_runs)
    rkd, rpd, rn = ref_qindex.fold_runs_device(ref_runs)
    assert n_real == rn == 5 * row0
    _same(kd, rkd)
    _same(pd, rpd)
    pk, pv = qindex.materialize_fold(kd, pd, n_real)
    rk, rv = ref_qindex.materialize_fold(rkd, rpd, rn)
    assert pk.tobytes() == rk.tobytes()
    assert np.array_equal(pv, rv)
    for r in port_runs:
        r.finish_dispatch()
        assert not r.materialized


PAD_WORDS = np.array([0, 1, 2, 0xFFFFFFFF], np.uint32)


def pad_edge_batch(rng, n):
    """A staged batch (numpy) whose pad words are drawn from 0, 1, 2 and
    2^32 - 1 (each at least once), not the staged 0/1 flag."""
    recs = rand_recs(rng, n)
    rows = rng.integers(0, 1 << 32, n).astype(np.uint32)
    staged = list(qindex.stage_query_batch(recs, rows, recs["timestamp"]))
    pad = rng.choice(PAD_WORDS, staged[3].shape[0])
    pad[:4] = PAD_WORDS
    staged[3] = pad
    return staged


@pytest.mark.parametrize("n", [7, 300])
def test_sorted_build_orders_every_pad_word_as_the_reference(n):
    """The sort is by the whole pad word, as the reference's 3-key sort on
    (pad, lo1, lo0): pad words 2 and 2^32 - 1 too."""
    staged = pad_edge_batch(np.random.default_rng(40 + n), n)
    pk, pp = qindex.query_index_keys_sorted(*_t(staged))
    rk, rp = ref_qindex.query_index_keys_sorted(*staged)
    _same(pk, rk)
    _same(pp, rp)


@pytest.mark.parametrize("case,n", SORT_EDGES)
def test_sorted_build_edges_match_reference(case, n):
    """The sorted build's radix-sort edge blocks (tests/exact_batches.py
    sort_block: equal keys, spans of 8 and 56 bits, a 64-bit composite,
    pad words over 1000 values, duplicates; n = 1, 300, 8190, 8192)
    through the port's plain version and the reference's jax sort."""
    staged = sort_block(np.random.default_rng(sum(map(ord, case)) + n), case, n)
    pk, pp = qindex.query_index_keys_sorted(*_t(staged))
    rk, rp = ref_qindex.query_index_keys_sorted(*staged)
    _same(pk, rk)
    _same(pp, rp)


def test_sorted_build_refuses_more_rows_than_the_cuda_sort_takes():
    """A tag block above SORTED_ROWS_MAX raises before any launch (meta
    tensors stand in for the card's); the plain version has no limit."""
    n = qindex.SORTED_ROWS_MAX * 2
    meta = [torch.empty(s, dtype=torch.uint32, device="meta")
            for s in ((n, 9), (n, 2), (n,), (n,))]
    with pytest.raises(ValueError, match="at most 8192"):
        qindex.query_index_keys_sorted(*meta)


# --- the lazy-run tier ---------------------------------------------------


def table_bytes(idx):
    out = []
    for lvl in idx.levels:
        for t in lvl:
            for f in idx._table_fences(t):
                bk, bv = idx._read_data_block(int(f["block"]), int(f["count"]))
                out.append(bk.tobytes())
                out.append(bv.tobytes())
    return b"".join(out)


def _index_pair(memtable_max):
    port = DurableIndex(MemGrid(block_count=8192, block_size=4096), unique=False,
                        memtable_max=memtable_max, name="query_rows", merge_hint="dups")
    ref = RefIndex(RefGrid(block_count=8192, block_size=4096), unique=False,
                   memtable_max=memtable_max, backend="jax", merge_hint="dups")
    return port, ref


def _drive(port, ref, rng, batches, n, read_after=None):
    row0 = 0
    for b in range(batches):
        recs = rand_recs(rng, n, constant=b % 2 == 0)
        rows = np.arange(row0, row0 + n, dtype=np.uint32)
        row0 += n
        port.insert_run_lazy(qindex.build_run(recs, rows, recs["timestamp"], CPU))
        ref.insert_run_lazy(ref_qindex.build_run(recs, rows, recs["timestamp"]))
        if b == read_after:
            key = np.zeros(1, dtype=KEY_DTYPE)
            key["lo"] = (np.uint64(scan.TAG_LEDGER) << np.uint64(56)) | np.uint64(1)
            key["hi"] = recs["timestamp"][0]
            assert np.array_equal(port.lookup_range(key[0]), ref.lookup_range(key[0]))
    port.flush_memtable()
    ref.flush_memtable()


def test_flush_tables_match_reference(monkeypatch):
    monkeypatch.setenv("TIGERBEETLE_TPU_DEVICE_MERGE", "1")
    port, ref = _index_pair(5 * 400 * 6 // 2)
    folds = []
    port._fold_on_device = (lambda f: lambda runs: folds.append(len(runs)) or f(runs))(
        port._fold_on_device)
    _drive(port, ref, np.random.default_rng(11), 6, 400)
    assert folds == [3, 3]  # each flush folded its three runs on the device
    assert table_bytes(port) == table_bytes(ref)
    assert port.count == ref.count


def test_mid_run_flush_same_cadence(monkeypatch):
    """memtable_max trips inside insert: the lazy path flushes at the same
    batch boundaries (grid allocation order is checkpoint bytes)."""
    monkeypatch.setenv("TIGERBEETLE_TPU_DEVICE_MERGE", "1")
    port, ref = _index_pair(137 * 5 * 3)
    _drive(port, ref, np.random.default_rng(12), 10, 137)
    assert len(port.levels[0]) == len(ref.levels[0]) > 1
    assert table_bytes(port) == table_bytes(ref)


def test_read_barrier_sends_the_flush_to_the_host_merge(monkeypatch):
    """A read between inserts materializes the lazy runs: that flush takes
    the host k-way merge, the next the device fold, and both give the
    reference's bytes."""
    monkeypatch.setenv("TIGERBEETLE_TPU_DEVICE_MERGE", "1")
    port, ref = _index_pair(5 * 200 * 3)
    folds = []
    port._fold_on_device = (lambda f: lambda runs: folds.append(len(runs)) or f(runs))(
        port._fold_on_device)
    _drive(port, ref, np.random.default_rng(13), 6, 200, read_after=1)
    assert folds == [3]  # the first flush went to the host
    assert len(port.levels[0]) == 2
    assert table_bytes(port) == table_bytes(ref)


def test_lookup_range_resolves_lazy_runs(monkeypatch):
    monkeypatch.setenv("TIGERBEETLE_TPU_DEVICE_MERGE", "1")
    rng = np.random.default_rng(8)
    port, ref = _index_pair(1 << 30)
    recs = rand_recs(rng, 100, constant=True)
    rows = np.arange(100, dtype=np.uint32)
    port.insert_run_lazy(qindex.build_run(recs, rows, recs["timestamp"], CPU))
    ref.insert_run_lazy(ref_qindex.build_run(recs, rows, recs["timestamp"]))
    key = np.zeros(1, dtype=KEY_DTYPE)
    key["lo"] = (np.uint64(scan.TAG_LEDGER) << np.uint64(56)) | np.uint64(1)
    key["hi"] = recs["timestamp"][0]
    got = port.lookup_range(key[0])
    assert len(got) >= 1
    assert np.array_equal(got, ref.lookup_range(key[0]))
    assert all(isinstance(m, tuple) for m in port._mem)


def test_prefetch_waits_for_the_fold_then_pulls_one_run_a_call():
    rng = np.random.default_rng(4)
    port, _ = _index_pair(1 << 30)
    host = DurableIndex(MemGrid(block_count=8192, block_size=4096), unique=False,
                        memtable_max=1 << 30, merge_hint="dups")
    for b in range(4):
        recs = rand_recs(rng, 200)
        rows = np.arange(b * 200, (b + 1) * 200, dtype=np.uint32)
        port.insert_run_lazy(qindex.build_run(recs, rows, recs["timestamp"], CPU))
        k, v = host_keys(recs, rows)
        host.insert_unsorted(k, v)
    assert not port.prefetch_lazy_one()  # the fold is intact: hands off
    assert not any(m.materialized for m in port._mem)
    port._mem[0].materialize()  # as a read barrier would
    polls = 0
    while port.prefetch_lazy_one():
        polls += 1
    assert polls == 2  # three left: True twice, then the last pull
    assert all(m.materialized for m in port._mem)
    port.flush_memtable()
    host.flush_memtable()
    assert table_bytes(port) == table_bytes(host)


def host_keys(recs, rows):
    """The host route's key block (StateMachine._store_query_index)."""
    n = len(recs)
    keys = np.empty(5 * n, dtype=KEY_DTYPE)
    for i, (tag, f_lo, f_hi) in enumerate(scan.QUERY_TAG_FIELDS):
        folded = scan.fold56(recs[f_lo], recs[f_hi] if f_hi else None)
        keys["lo"][i * n:(i + 1) * n] = (np.uint64(tag) << np.uint64(56)) | folded
        keys["hi"][i * n:(i + 1) * n] = recs["timestamp"]
    return keys, np.tile(rows, 5)


# --- the slice as a whole -------------------------------------------------

CFG = Config(
    name="unit", accounts_max=1 << 10, transfers_max=1 << 14, batch_max=8190,
    lsm_block_size=1 << 12, grid_block_count=1 << 12, grid_cache_blocks=64,
    index_memtable_rows=512,
)
N_ACCOUNTS = 24


def _transfer_batch(rng, first_id, n):
    recs = np.zeros(n, dtype=ref_types.TRANSFER_DTYPE)
    recs["id_lo"] = np.arange(first_id, first_id + n, dtype=np.uint64)
    dr = rng.integers(1, N_ACCOUNTS + 1, n).astype(np.uint64)
    cr = rng.integers(1, N_ACCOUNTS + 1, n).astype(np.uint64)
    recs["debit_account_id_lo"] = dr
    recs["credit_account_id_lo"] = np.where(cr == dr, cr % N_ACCOUNTS + 1, cr)
    recs["amount_lo"] = 1
    recs["ledger"] = 1
    recs["code"] = rng.integers(1, 5, n)
    recs["user_data_64"] = rng.choice(
        np.array([7, 1 << 56, (1 << 64) - 1, 1 << 63], np.uint64), n)
    recs["user_data_32"] = rng.integers(0, 3, n)
    return recs


def _filters(rng, ts_max):
    out = []
    for k in range(12):
        f = np.zeros(1, dtype=ref_types.QUERY_FILTER_V2_DTYPE)[0]
        f["limit"] = 8190
        if k % 3 == 0:
            f["debit_account_id_lo"] = rng.integers(1, N_ACCOUNTS + 1)
            f["code"] = rng.integers(1, 5)
            f["ledger"] = 1
        elif k % 3 == 1:
            f["user_data_64"] = [7, 1 << 56, (1 << 64) - 1, 1 << 63][k % 4]
            f["user_data_32"] = k % 3
        else:
            f["code"] = 2
            f["flags"] = 1  # reversed
        w0 = int(rng.integers(1, max(ts_max // 2, 2)))
        f["timestamp_min"], f["timestamp_max"] = w0, w0 + ts_max // 2
        out.append(f)
    return out


@pytest.mark.parametrize("ref_route", ["0", "1"])
def test_state_machine_slice_matches_reference(ref_route, monkeypatch):
    """Batches of 50-300 transfers with varying queryable columns through
    the port's CPU machine on the device query-index route and the
    reference (host route with "0", its device route with "1"); a query
    after the third batch materializes lazy runs, so both the device fold
    and the host merge run on the port."""
    monkeypatch.setenv("TIGERBEETLE_TPU_DEVICE_MERGE", ref_route)
    rng = np.random.default_rng(31)
    ref = RefSM(CFG, backend="jax")
    port = PortSM(CFG, device="cpu", device_query_index=True)
    assert port._qindex_device and ref._qindex_device is (ref_route == "1")
    accounts = ref_types.batch(
        [ref_types.account(id=i + 1, ledger=1, code=10) for i in range(N_ACCOUNTS)],
        ref_types.ACCOUNT_DTYPE,
    )
    assert port.create_accounts(accounts.copy()).tobytes() == ref.create_accounts(accounts.copy()).tobytes()
    folds, merges = [], []
    tree = port.query_rows
    tree._fold_on_device = (lambda f: lambda runs: folds.append(len(runs)) or f(runs))(
        tree._fold_on_device)
    monkeypatch.setattr(port_tree, "merge_host_kway", (
        lambda f: lambda k, v: merges.append(len(k)) or f(k, v))(port_tree.merge_host_kway))
    next_id = 1000
    for i, n in enumerate((50, 40, 60, 50, 200, 77, 300, 64)):
        ev = _transfer_batch(rng, next_id, n)
        next_id += n
        assert port.create_transfers(ev.copy()).tobytes() == ref.create_transfers(ev.copy()).tobytes()
        if i == 1:
            for f in _filters(rng, int(ref.commit_timestamp))[:2]:
                assert port.query_transfers(f).tobytes() == ref.query_transfers(f).tobytes()
    ts_max = int(ref.commit_timestamp)
    for f in _filters(rng, ts_max):
        got = port.query_transfers(f)
        assert got.tobytes() == ref.query_transfers(f).tobytes()
    for a in range(1, N_ACCOUNTS + 1, 5):
        assert (port.get_account_transfers(a).tobytes()
                == ref.get_account_transfers(a).tobytes())
    assert folds and 3 in merges  # the device fold and the host merge both ran
    assert table_bytes(port.query_rows) == table_bytes(ref.query_rows)
    assert port.query_rows.count == ref.query_rows.count
