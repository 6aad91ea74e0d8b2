"""The device query-index route policy (ops/merge.device_merge_pays) and
the two routes of the port's StateMachine against the reference's.

`device_merge_pays(device)` is the one policy of the device query
pipeline: on the CPU it agrees with the reference's (which answers for
XLA's CPU backend) with the reference's TIGERBEETLE_TPU_DEVICE_MERGE
unset, on CUDA it is on, the port reads the variable under no value, and
a machine built with `device_query_index=None` takes the policy. On a small seeded stream (creates,
a beat per op, a storm, lookups, queries, materialized scans) the port's
machine on the host route and on the device route (plain versions,
device="cpu"), and the reference's machine with the variable at 0 and at
1, give the same codes, lookups and query results; the host route calls
none of the device route's kernels (the sorted key build, the tiled
merge, the compaction fold, the intersect) and the device route calls
each."""

import numpy as np
import pytest
import torch

from tigerbeetle_tpu import types as ref_types
from tigerbeetle_tpu.constants import Config
from tigerbeetle_tpu.models.state_machine import StateMachine as RefSM
from tigerbeetle_tpu.ops import merge as ref_merge
from tigerbeetle_tpu_torch.lsm import scan
from tigerbeetle_tpu_torch.models.state_machine import StateMachine as PortSM
from tigerbeetle_tpu_torch.ops import merge, qindex, scanops

VAR = "TIGERBEETLE_TPU_DEVICE_MERGE"
CFG = Config(
    name="unit", accounts_max=1 << 10, transfers_max=1 << 15, batch_max=8190,
    lsm_block_size=1 << 12, grid_block_count=1 << 13, grid_cache_blocks=64,
    index_memtable_rows=512, compact_quota_entries=600,
)
N_ACC = 24


@pytest.mark.parametrize("value", [None, "0", "1", "", "false", "yes"])
def test_device_merge_pays_matches_the_reference_on_the_cpu(value, monkeypatch):
    monkeypatch.delenv(VAR, raising=False)
    want = ref_merge.device_merge_pays()
    if value is not None:
        monkeypatch.setenv(VAR, value)
    assert merge.device_merge_pays("cpu") is want is False
    # The card takes the route whatever the variable says.
    assert merge.device_merge_pays(torch.device("cuda", 0)) is True


@pytest.mark.parametrize("value,route", [(None, False), ("1", False), ("0", False)])
def test_a_machine_takes_the_policy_unless_told(value, route, monkeypatch):
    if value is None:
        monkeypatch.delenv(VAR, raising=False)
    else:
        monkeypatch.setenv(VAR, value)
    sm = PortSM(CFG, device="cpu")
    assert sm._qindex_device is route
    assert all((t.device is not None) is route
               for t in (sm.transfer_index, sm.account_rows, sm.query_rows))
    for flag in (True, False):
        assert PortSM(CFG, device="cpu", device_query_index=flag)._qindex_device is flag


def _batch(rng, first_id, n):
    recs = np.zeros(n, dtype=ref_types.TRANSFER_DTYPE)
    recs["id_lo"] = np.arange(first_id, first_id + n, dtype=np.uint64)
    dr = rng.integers(1, N_ACC + 1, n).astype(np.uint64)
    cr = rng.integers(1, N_ACC + 1, n).astype(np.uint64)
    recs["debit_account_id_lo"] = dr
    recs["credit_account_id_lo"] = np.where(cr == dr, cr % N_ACC + 1, cr)
    recs["amount_lo"] = rng.integers(1, 100, n)
    recs["ledger"] = 1
    recs["code"] = rng.integers(1, 5, n)
    recs["user_data_64"] = rng.choice(np.array([7, 1 << 56, (1 << 64) - 1], np.uint64), n)
    return recs


def _filters(ts_max):
    rng = np.random.default_rng(77)
    out = []
    for k in range(9):
        f = np.zeros(1, dtype=ref_types.QUERY_FILTER_V2_DTYPE)[0]
        f["limit"] = 8190
        if k % 3 == 0:
            f["debit_account_id_lo"] = rng.integers(1, N_ACC + 1)
            f["code"], f["ledger"] = rng.integers(1, 5), 1
        elif k % 3 == 1:
            f["user_data_64"] = (7, 1 << 56, (1 << 64) - 1)[k % 3]
        else:
            f["code"], f["flags"] = 2, 1  # reversed
        w0 = int(rng.integers(1, max(ts_max // 2, 2)))
        f["timestamp_min"], f["timestamp_max"] = w0, w0 + ts_max // 2
        out.append(f)
    return out


def _drive(sm):
    """Creates with a beat per op, a storm drained op by op, then every
    account's lookup, the queries and (the port's) materialized scans."""
    rng = np.random.default_rng(5)
    out = []
    acc = np.zeros(N_ACC, dtype=ref_types.ACCOUNT_DTYPE)
    acc["id_lo"] = np.arange(1, N_ACC + 1, dtype=np.uint64)
    acc["ledger"], acc["code"] = 1, 10
    out.append(sm.create_accounts(acc).tobytes())
    next_id = 1000
    for n in (300, 50, 400, 120, 500, 64, 300, 250):
        out.append(sm.create_transfers(_batch(rng, next_id, n)).tobytes())
        next_id += n
        sm.compact_beat()
    sm.request_major_compaction()
    beats = 0
    while sm.compaction_storm_active():
        out.append(sm.create_transfers(_batch(rng, next_id, 200)).tobytes())
        next_id += 200
        sm.compact_beat()
        beats += 1
        assert beats < 200
    ids = np.arange(1, N_ACC + 1, dtype=np.uint64)
    out.append(sm.lookup_accounts(ids, np.zeros_like(ids)).tobytes())
    for f in _filters(int(sm.commit_timestamp)):
        out.append(sm.query_transfers(f).tobytes())
    for a in range(1, N_ACC + 1, 4):
        out.append(sm.get_account_transfers(a).tobytes())
    scans = []
    if hasattr(sm, "scan_builder"):
        sm.flush_deferred()
        ts = int(sm.commit_timestamp)
        for code in range(1, 5):
            b = sm.scan_builder(1, ts)
            b.where_account(code * 5, 0)
            b.where_field(scan.TAG_CODE, code)
            b.where_field(scan.TAG_LEDGER, 1)
            scans.append(b.execute("materialize").tobytes())
    return out, scans


def _counting(monkeypatch, calls):
    for mod, name in ((qindex, "query_index_keys_sorted"), (qindex, "merge_kernel_tiled"),
                      (merge, "merge_kernel_tiled"), (merge, "compact_fold_kernel"),
                      (scanops, "scan_intersect_mask")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, (lambda f, key: lambda *a, **k: (
            calls.__setitem__(key, calls.get(key, 0) + 1), f(*a, **k))[1])(fn, name))


def test_both_routes_answer_as_the_reference_under_both_settings(monkeypatch):
    answers = {}
    for value in ("0", "1"):
        monkeypatch.setenv(VAR, value)
        ref = RefSM(CFG, backend="jax")
        assert ref._qindex_device is (value == "1")
        answers[f"ref{value}"] = _drive(ref)[0]
    monkeypatch.delenv(VAR)
    calls = {"host": {}, "device": {}}
    scans = {}
    for route in ("host", "device"):
        with monkeypatch.context() as m:
            _counting(m, calls[route])
            sm = PortSM(CFG, device="cpu", device_query_index=route == "device")
            answers[route], scans[route] = _drive(sm)
    assert answers["host"] == answers["device"] == answers["ref0"] == answers["ref1"]
    assert scans["host"] == scans["device"] and any(len(s) for s in scans["host"])
    assert calls["host"] == {}
    assert set(calls["device"]) == {"query_index_keys_sorted", "merge_kernel_tiled",
                                    "compact_fold_kernel", "scan_intersect_mask"}
