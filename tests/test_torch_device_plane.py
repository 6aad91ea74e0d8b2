"""The port's device plane (devicestats.py and the tracer's device
ledgers) against the reference package's.

The memory ledger, the dispatch windows, the transfer-bandwidth
histograms and `xfer_summary` are held to the reference's on the same
tracer inputs (one fake clock drives both). The cost model is the port's
own: `COSTS` rows give hand-counted bytes at small shapes and PERF.md's
table bytes at chip_smoke.py's shapes (as meta tensors: no memory), and
`cost_table` joins them with the windows of a live CPU workload.
`device_status` answers with a superset of the reference's keys, and a
CPU replica's never touches CUDA. The reference's flight-dump snapshot,
token-eviction and `device_mem_release` tests have their twins in
tests/test_torch_lifecycle.py.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tigerbeetle_tpu import devicestats as ref_ds
from tigerbeetle_tpu import tracer as ref_tracer
from tigerbeetle_tpu import types
from tigerbeetle_tpu.constants import Config
from tigerbeetle_tpu_torch import devicestats, tracer
from tigerbeetle_tpu_torch.models.state_machine import StateMachine as PortSM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = Config(name="unit", accounts_max=1 << 12, transfers_max=1 << 14, batch_max=64)


@pytest.fixture
def clean_tracer():
    """Both packages' tracers enabled and reset, restored afterwards."""
    was = (tracer.enabled(), ref_tracer.enabled())
    for t in (tracer, ref_tracer):
        t.enable()
        t.reset()
    devicestats.reset()
    ref_ds.reset()
    yield
    for t, on in zip((tracer, ref_tracer), was):
        t.reset()
        if not on:
            t.disable()
    devicestats.reset()
    ref_ds.reset()


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"tool_{name}_torch_dp", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _meta(*shape, dtype=torch.uint32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _state(a):
    return tuple([_meta(a, 4)] * 4 + [_meta(a), _meta(a)])


def _batch(n):
    i32 = torch.int32
    return (_meta(n, 4), _meta(n, dtype=i32), _meta(n, dtype=i32), _meta(n, 4), _meta(n, 4),
            _meta(n), _meta(n), _meta(n), _meta(n), _meta(n, 2))


def _pending(n):
    i32 = torch.int32
    return (_meta(n, dtype=torch.bool), _meta(n, 4), _meta(n, dtype=i32), _meta(n, dtype=i32),
            _meta(n, 2), _meta(n), _meta(n, dtype=i32), _meta(n, dtype=i32))


# --- device memory ledger ---------------------------------------------------


class TestDeviceMemLedger:
    def test_set_adjust_retire_and_high_water_match_the_reference(self, clean_tracer):
        for t in (tracer, ref_tracer):
            t.device_mem_set("balances", 1000)
            t.device_mem_adjust("compact_fold", 500)
            t.device_mem_adjust("compact_fold", -200)
            t.device_mem_set("scratch.b256", 10)
            t.device_mem_set("scratch.b2048", 20)
            t.device_mem_retire_prefix("scratch.b256")
        got, want = tracer.device_mem_totals(), ref_tracer.device_mem_totals()
        assert got == want
        assert got["owners"] == {"balances": 1000, "compact_fold": 300, "scratch.b2048": 20}
        assert got["high_water_bytes"] == 1500
        g = tracer.gauges()
        assert g["device.mem.balances.bytes"] == 1000.0
        assert "device.mem.scratch.b256.bytes" not in g
        assert "device.mem.scratch.b2048.bytes" in g

    def test_adjust_clamps_at_zero(self, clean_tracer):
        tracer.device_mem_adjust("query_runs", 100)
        tracer.device_mem_adjust("query_runs", -500)
        assert tracer.device_mem_totals()["owners"]["query_runs"] == 0

    def test_lifecycle_flat_key_gated_on_nonzero(self, clean_tracer):
        assert "device_mem_high_water_bytes" not in tracer.lifecycle_summary()["flat"]
        tracer.device_mem_set("balances", 4096)
        assert tracer.lifecycle_summary()["flat"]["device_mem_high_water_bytes"] == 4096.0

    def test_reset_rearms_ledger(self, clean_tracer):
        tracer.device_mem_set("balances", 4096)
        tracer.reset()
        t = tracer.device_mem_totals()
        assert not t["owners"] and t["high_water_bytes"] == 0

    def test_disabled_tracer_is_inert(self, clean_tracer):
        tracer.disable()
        tracer.device_mem_set("balances", 4096)
        assert tracer.device_mem_totals()["owners"] == {}


# --- dispatch/finish windows + transfer bandwidth ---------------------------


def _drive_windows(t, clock):
    """The same dispatch/finish script on either tracer, on `clock`."""
    tok = t.device_dispatch("create_transfers_fast", h2d_bytes=1_000_000)
    clock[0] += 2_000_000
    t.device_finish("create_transfers_fast", tok, d2h_bytes=4096)
    tok = t.device_dispatch("read_balances", h2d_bytes=65_536)
    clock[0] += 30_000
    t.device_finish("read_balances", tok, d2h_bytes=262_144)
    tok = t.device_dispatch("merge_kernel_tiled")
    clock[0] += 5_000
    t.device_finish("merge_kernel_tiled", tok)
    t.count("sm.stored_transfers", 100)


class TestDispatchWindow:
    def test_windows_and_xfer_summary_match_the_reference(self, clean_tracer, monkeypatch):
        clock = [10**12]
        monkeypatch.setattr(time, "perf_counter_ns", lambda: clock[0])
        for t in (tracer, ref_tracer):
            _drive_windows(t, clock)
        got, want = tracer.snapshot(), ref_tracer.snapshot()
        for key in ("device.step.create_transfers_fast", "device.step.read_balances",
                    "device.xfer.h2d.gbps", "device.xfer.d2h.gbps", "device.h2d_bytes",
                    "device.d2h_bytes", "device.create_transfers_fast.dispatches"):
            assert got[key]["count"] == want[key]["count"], key
        # Both snapshots round their quantiles to 0.1 us (0.1 GB/s on
        # these histograms).
        for key in ("device.xfer.h2d.gbps", "device.xfer.d2h.gbps"):
            for q in ("p50_us", "p99_us"):
                assert got[key][q] == want[key][q], (key, q)
        out = devicestats.xfer_summary()
        assert out == ref_ds.xfer_summary()
        # 1 MB over 2 ms is 0.5 GB/s; the p50_us convention reads GB/s.
        assert out["h2d_windows"] == 2 and out["d2h_windows"] == 2
        assert out["h2d_bytes"] == 1_065_536 and out["d2h_bytes"] == 266_240
        assert out["bytes_per_transfer"] == round((1_065_536 + 266_240) / 100, 1)

    def test_inflight_window_depth(self, clean_tracer):
        t1 = tracer.device_dispatch("create_transfers_fast")
        t2 = tracer.device_dispatch("create_transfers_fast")
        t3 = tracer.device_dispatch("read_balances")
        inflight = tracer.device_inflight()
        assert inflight["entries"] == {"create_transfers_fast": 2, "read_balances": 1}
        assert inflight["window_depth"] == 3
        for e, t in (("create_transfers_fast", t1), ("create_transfers_fast", t2),
                     ("read_balances", t3)):
            tracer.device_finish(e, t)
        assert tracer.device_inflight()["window_depth"] == 0

    def test_disabled_dispatch_returns_zero_token(self, clean_tracer):
        tracer.disable()
        tok = tracer.device_dispatch("create_transfers_fast", h2d_bytes=1)
        assert tok == 0
        tracer.device_finish("create_transfers_fast", tok)
        assert tracer.device_inflight()["window_depth"] == 0

    def test_unknown_entry_rejected(self, clean_tracer):
        with pytest.raises(ValueError, match="unknown device entry"):
            tracer.device_dispatch("mystery_kernel")

    def test_overlapping_windows_render_as_async_pairs(self, clean_tracer):
        t1 = tracer.device_dispatch("create_transfers_fast", h2d_bytes=100)
        time.sleep(0.001)
        t2 = tracer.device_dispatch("create_transfers_fast", h2d_bytes=200)
        time.sleep(0.001)
        tracer.device_finish("create_transfers_fast", t1, d2h_bytes=10)
        tracer.device_finish("create_transfers_fast", t2)
        dev = [e for e in tracer.export_trace()["traceEvents"] if e.get("cat") == "device"]
        begins = [e for e in dev if e["ph"] == "b"]
        ends = {e["id"]: e["ts"] for e in dev if e["ph"] == "e"}
        assert len(begins) == 2 and begins[0]["id"] != begins[1]["id"]
        assert begins[0]["args"] == {"h2d_bytes": 100, "d2h_bytes": 10}
        assert begins[1]["ts"] < ends[begins[0]["id"]]
        assert {b["id"] for b in begins} == set(ends)

    def test_empty_registry_degrades(self, clean_tracer):
        out = devicestats.xfer_summary()
        assert out == ref_ds.xfer_summary()
        assert out["h2d_bytes"] == 0 and "h2d_gbps_p50" not in out
        assert "bytes_per_transfer" not in out


# --- cost model: shapes, COSTS rows, roofline --------------------------------


class TestCostModel:
    def test_note_call_captures_and_bounds_shapes(self, clean_tracer):
        a = torch.zeros((256, 4), dtype=torch.uint32)
        devicestats.note_call("create_transfers_fast", (a,), bucket=256)
        devicestats.note_call("create_transfers_fast", (a,), bucket=256)
        shapes = devicestats.observed_shapes()
        assert shapes["create_transfers_fast"] == ["256x4:uint32"]
        for n in range(devicestats._SHAPES_PER_ENTRY_MAX + 8):
            devicestats.note_call("read_balances", (torch.zeros(n + 1, dtype=torch.int32),))
        assert len(devicestats.observed_shapes()["read_balances"]) == devicestats._SHAPES_PER_ENTRY_MAX

    def test_note_call_disabled_tracer_noop(self, clean_tracer):
        tracer.disable()
        devicestats.note_call("read_balances", (torch.zeros(4, dtype=torch.int32),))
        assert "read_balances" not in devicestats.observed_shapes()

    def test_retire_bucket_drops_rows(self, clean_tracer):
        a, b = torch.zeros(256, dtype=torch.uint32), torch.zeros(512, dtype=torch.uint32)
        devicestats.note_call("create_transfers_fast", (a,), bucket=256)
        devicestats.note_call("create_transfers_fast", (b,), bucket=512)
        devicestats.note_call("read_balances", (a,), bucket=256)
        devicestats.retire_bucket(256)
        shapes = devicestats.observed_shapes()
        assert shapes["create_transfers_fast"] == ["512:uint32"]
        assert "read_balances" not in shapes

    def test_spec_round_trip_rebuilds_meta_arguments(self, clean_tracer):
        st = tuple(torch.zeros(s, dtype=torch.uint32) for s in ((8, 4),) * 4 + ((8,),) * 2)
        devicestats.note_call("read_balances", (st, torch.zeros(16, dtype=torch.int32)),
                              {"flag": True})
        (key, rec), = devicestats.observed_specs()["read_balances"].items()
        assert key == "8x4:uint32|" * 4 + "8:uint32|8:uint32|16:int32|flag=True"
        state, slots = devicestats.args_of(rec["spec"])
        assert slots.device.type == "meta" and slots.shape == (16,) and slots.dtype == torch.int32
        assert len(state) == 6 and state[0].shape == (8, 4)
        assert devicestats.args_of(rec["kwspec"]["flag"]) is True

    def test_classify_against_the_cards_balance_point(self):
        assert devicestats.classify(None, 100) == "n/a"
        assert devicestats.classify(100, None) == "n/a"
        assert 19 < devicestats.BALANCE_OPS_PER_BYTE < 21  # 67 TOP/s over 3.35 TB/s
        assert devicestats.classify(10 * 100, 100) == "bytes"
        assert devicestats.classify(30 * 100, 100) == "operations"

    def test_commit_rows_hand_counted_at_small_shapes(self):
        """A = 16 accounts, n = 4 events, k = 4 slots."""
        a, n, k = 16, 4, 4
        state, b = _state(a), _batch(n)
        tables = 4 * a * 16
        batch = n * (16 + 4 + 4 + 16 + 16 + 4 + 4 + 4 + 4 + 8)
        # the four tables in and out, batch and host codes in, ledger and
        # flags of both slots, the codes and the bail word out
        assert devicestats.cost("create_transfers_fast", (state, b, _meta(n))) == (
            2 * tables + batch + 4 * n + 2 * n * 4 + 4 * n + 1, 24 * a + 120 * n)
        reg = (state, _meta(k, dtype=torch.int32), _meta(k), _meta(k), _meta(k, dtype=torch.bool))
        assert devicestats.cost("register_accounts", reg) == (13 * k + 8 * k, 4 * k)
        assert devicestats.cost("register_accounts", reg, k_in=3) == (13 * k + 8 * 3, 4 * k)
        assert devicestats.cost("read_balances", (state, _meta(k, dtype=torch.int32))) == (
            4 * k + 2 * 4 * k * 16, 8 * k)
        assert devicestats.cost("write_balances", (state, _meta(k, dtype=torch.int32),
                                                   *[_meta(k, 4)] * 4)) == (
            4 * k + 4 * 16 * k + 4 * 16 * k, 8 * k)
        p, chain = _pending(n), _meta(n, dtype=torch.int32)
        pend = n * (1 + 16 + 4 + 4 + 8 + 4 + 4 + 4)
        plan = tuple([_meta(2 * n, dtype=torch.int32)] * 4 + [_meta(n, dtype=torch.int32)] * 4)
        exact_io = 2 * tables + batch + 4 * n + pend + 4 * n + 2 * 2 * n * 4 + n * (4 + 16 + 128) + 1
        sweep_ops = 2 * n * 52 * 10 + n * 200
        assert devicestats.cost("create_transfers_exact", (state, b, _meta(n), p, chain),
                                sweeps=3) == (exact_io, 8 * a + 3 * sweep_ops)
        assert devicestats.cost("create_transfers_exact", (state, b, _meta(n), p, chain, plan),
                                sweeps=1)[0] == exact_io + 4 * 2 * n * 4 + 4 * n * 4
        # no sweeps counted: max_sweeps bounds them
        assert devicestats.cost("create_transfers_exact", (state, b, _meta(n), p, chain))[1] == (
            8 * a + 64 * sweep_ops)
        plan_bytes = 7 * 4 * n + 4 * (2 * n * 4 + n * 4)
        assert devicestats.cost("exact_sort_plan", (b, p, chain, a), passes=(2, 1)) == (
            plan_bytes, (2 * 2 * n + 1 * n) * 40 + 3 * n * 20)
        # shape bound: a slot of 5 bits with a chain of 3 bits, one pass;
        # a group of 3 bits, one pass
        assert devicestats.cost("exact_sort_plan", (b, p, chain, a))[1] == (
            (1 * 2 * n + 1 * n) * 40 + 3 * n * 20)
        grouped = [state] * 3
        assert devicestats.cost("register_accounts_sharded", (grouped, *reg[1:]), k_in=2) == (
            13 * k + 8 * 2 * 3, 4 * k + 2 * 2 * 3)
        halves = [_state(a // 2)] * 4  # dp 2 x shard 2: each slot in two tables
        wb = (halves, [0, a // 2, 0, a // 2], _meta(k, dtype=torch.int32), *[_meta(k, 4)] * 4, a)
        assert devicestats.cost("write_balances_sharded", wb) == (
            4 * k + 4 * 16 * k + 64 * 2 * k, k * (4 + 2 * 4))
        assert devicestats.cost("write_balances_sharded", wb, landed=5)[0] == 4 * k + 4 * 16 * k + 64 * 5

    def test_commit_rows_give_the_perf_table_bytes_at_chip_smoke_shapes(self):
        """PERF.md's table: rows 1, 2, 3, 4, 5a, 5b and 14 at A = 2^20,
        n = 8192 (k = 8192 registrations, 90% installed; k = 16,384 slot
        reads and writes; the config-3 batch's three sweeps and its host
        plan; 7,373 of 8,192 registrations into 8 tables), in MB."""
        a, n = 1 << 20, 8192
        state, b, host = _state(a), _batch(n), _meta(n)
        p, chain = _pending(n), _meta(n, dtype=torch.int32)
        plan = tuple([_meta(2 * n, dtype=torch.int32)] * 4 + [_meta(n, dtype=torch.int32)] * 4)
        reg = (_meta(n, dtype=torch.int32), _meta(n), _meta(n), _meta(n, dtype=torch.bool))
        slots = _meta(2 * n, dtype=torch.int32)
        mb = lambda entry, args, **kw: round(devicestats.cost(entry, args, **kw)[0] / 1e6, 2)
        assert mb("create_transfers_fast", (state, b, host)) == 135.0
        assert mb("register_accounts", (state, *reg), k_in=int(0.9 * n)) == 0.17
        assert mb("read_balances", (state, slots)) == 2.16
        assert mb("write_balances", (state, slots, *[_meta(2 * n, 4)] * 4)) == 2.16
        assert mb("create_transfers_exact", (state, b, host, p, chain, plan), sweeps=3) == 137.04
        assert mb("exact_sort_plan", (b, p, chain, a), passes=(3, 2)) == 0.62
        assert mb("register_accounts_sharded", ([state] * 8, *reg), k_in=7373) == 0.58

    def test_cost_table_joins_a_live_cpu_workload(self, clean_tracer):
        """The port's CPU machine: rows for the entries it called, bytes
        from the recorded shapes, the measured window times joined in."""
        sm = PortSM(CFG, device="cpu")
        rng = np.random.default_rng(3)
        acc = np.zeros(32, dtype=types.ACCOUNT_DTYPE)
        acc["id_lo"] = np.arange(1, 33)
        acc["ledger"], acc["code"] = 1, 10
        assert len(sm.create_accounts(acc)) == 0
        for i in range(3):
            ev = np.zeros(48, dtype=types.TRANSFER_DTYPE)
            ev["id_lo"] = np.arange(1000 + 48 * i, 1048 + 48 * i)
            ev["debit_account_id_lo"] = rng.integers(1, 17, 48)
            ev["credit_account_id_lo"] = rng.integers(17, 33, 48)
            ev["amount_lo"], ev["ledger"], ev["code"] = 1, 1, 7
            assert len(sm.create_transfers(ev)) == 0
        sm.lookup_accounts(np.arange(1, 9, dtype=np.uint64), np.zeros(8, dtype=np.uint64))
        rows = devicestats.cost_table()
        by_entry = {r["entry"]: r for r in rows}
        assert {"create_transfers_fast", "register_accounts", "read_balances"} <= set(by_entry)
        fast = by_entry["create_transfers_fast"]
        assert fast["calls"] == 3 and fast["ms_per_call"] > 0
        want = devicestats.cost("create_transfers_fast", devicestats.args_of(fast["spec"]))
        assert (fast["bytes"], fast["ops"]) == want
        assert fast["bytes"] >= 2 * 4 * CFG.accounts_max * 16
        assert fast["bound"] == "bytes" and fast["bound_ms"] > 0
        assert fast["achieved_gbps"] > 0 and fast["bound_share"] > 0
        for r in rows:
            assert r["bytes"] is not None, r["entry"]

    def test_commit_depth_passthrough_and_reference_keys(self, clean_tracer):
        class _R:
            commit_depth = 4

        assert devicestats.device_status(_R())["commit_depth"] == 4
        assert "commit_depth" not in devicestats.device_status(object())
        assert set(ref_ds.device_status(_R())) <= set(devicestats.device_status(_R()))
        assert devicestats.device_status()["backend"] == "none"


# --- device_status and CUDA ---------------------------------------------------


class TestDeviceStatus:
    @staticmethod
    def _replica(device):
        class _SM:
            pass

        class _R:
            commit_depth = 2

        sm = _SM()
        sm.device = torch.device(device)
        r = _R()
        r.state_machine = sm
        return r

    def test_a_cpu_replica_never_touches_cuda(self, clean_tracer, monkeypatch):
        def forbidden(*a, **k):
            raise AssertionError("a CPU replica's /device touched CUDA")

        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "memory_stats", forbidden)
        monkeypatch.setattr(torch.cuda, "get_device_name", forbidden)
        st = devicestats.device_status(self._replica("cpu"))
        assert st["backend"] == "cpu" and "backend_reported" not in st["mem"]

    def test_cuda_memory_read_only_once_cuda_is_initialized(self, clean_tracer, monkeypatch):
        def forbidden(*a, **k):
            raise AssertionError("memory_stats read before CUDA was initialized")

        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
        monkeypatch.setattr(torch.cuda, "memory_stats", forbidden)
        st = devicestats.device_status(self._replica("cuda:0"))
        assert st["backend"] == "cuda" and "backend_reported" not in st["mem"]
        stats = {"allocated_bytes.all.current": 4096, "allocated_bytes.all.peak": 8192,
                 "reserved_bytes.all.current": 1 << 21}
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: stats)
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "a card")
        st = devicestats.device_status(self._replica("cuda:0"))
        assert st["mem"]["backend_reported"] == {
            "bytes_in_use": 4096, "peak_bytes_in_use": 8192, "reserved_bytes": 1 << 21,
            "source": "torch.cuda.memory_stats"}
        assert st["device_name"] == "a card" and st["commit_depth"] == 2

    def test_device_top_renders_both_packages_payloads(self, clean_tracer):
        devicestats.note_call("read_balances", (_state(16), torch.zeros(4, dtype=torch.int32)))
        tok = tracer.device_dispatch("read_balances", h2d_bytes=16)
        tracer.device_finish("read_balances", tok, d2h_bytes=256)
        port = devicestats.device_status(self._replica("cpu"))
        ref = ref_ds.device_status()
        for tool in ("torch_device_top", "device_top"):
            out = _load_tool(tool).render([port, ref, None], [1, 2, 3])
            assert "port 1: backend=cpu" in out and "read_balances" in out
            assert "port 3: UNREACHABLE" in out


def test_trace_summary_reads_the_ports_trace_unchanged(clean_tracer, tmp_path):
    """tools/trace_summary.py (it imports neither package) summarizes the
    port's tracer.export_trace() of a small CPU run as it is."""
    sm = PortSM(CFG, device="cpu")
    acc = np.zeros(16, dtype=types.ACCOUNT_DTYPE)
    acc["id_lo"] = np.arange(1, 17)
    acc["ledger"], acc["code"] = 1, 10
    assert len(sm.create_accounts(acc)) == 0
    ev = np.zeros(32, dtype=types.TRANSFER_DTYPE)
    ev["id_lo"] = np.arange(100, 132)
    ev["debit_account_id_lo"], ev["credit_account_id_lo"] = 1, 2
    ev["amount_lo"], ev["ledger"], ev["code"] = 1, 1, 7
    assert len(sm.create_transfers(ev)) == 0
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(tracer.export_trace()))
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools", "trace_summary.py"),
                          str(path)], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "sm.create_transfers" in out.stdout and "MainThread" in out.stdout
