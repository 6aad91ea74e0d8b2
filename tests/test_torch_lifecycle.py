"""The port's per-operation lifecycle, flight recorder and device-step
profiler held to the reference's: the twins of the cases of
tests/test_lifecycle.py that tests/test_torch_flight.py does not already
twin (its bench-gate cases wait with the port's bench gate), and of the
reference's device-plane cases of tests/test_device_plane.py that need
the tracer's own functions (device_mem_release, the bound on abandoned
dispatch windows, the flight dump's device block).

The scripted ops inject known stamp times, so both packages'
decompositions are exact and compared key by key; only the summary
window (and the occupancy derived from it) follows the host clock."""

import glob
import json
import subprocess
import sys
import threading

import numpy as np
import pytest

import cluster_scenarios as cs
from tigerbeetle_tpu import tracer as ref_tracer
from tigerbeetle_tpu_torch import tracer

BOTH = (tracer, ref_tracer)
IDS = ["port", "reference"]
# The flight dumps' file stems.
STEM = {tracer: "tbtorch_flight", ref_tracer: "tbtpu_flight"}

# A scripted op: (stamp index, offset ns from the op's arrival).
SCRIPT = (
    (tracer.OP_ARRIVE, 0),
    (tracer.OP_PREPARE, 1_000_000),      # queue.request   1.0 ms
    (tracer.OP_WAL_ENQUEUE, 1_500_000),  # service.prepare 0.5 ms
    (tracer.OP_WAL_WRITE, 3_500_000),    # queue.wal       2.0 ms
    (tracer.OP_WAL_DURABLE, 7_500_000),  # service.wal     4.0 ms
    (tracer.OP_COMMIT_SUBMIT, 8_000_000),   # queue.quorum 0.5 ms
    (tracer.OP_EXEC_START, 9_000_000),      # queue.commit 1.0 ms
    (tracer.OP_EXEC_END, 17_000_000),       # service.execute 8.0 ms
    (tracer.OP_REPLY, 18_000_000),          # service.reply 1.0 ms
    (tracer.OP_STORE_SUBMIT, 17_100_000),
    (tracer.OP_STORE_START, 20_100_000),    # queue.store   3.0 ms
    (tracer.OP_STORE_END, 26_100_000),      # service.store 6.0 ms
)
EXPECT_MS = {
    "queue.request": 1.0, "service.prepare": 0.5, "queue.wal": 2.0,
    "service.wal": 4.0, "queue.quorum": 0.5, "queue.commit": 1.0,
    "service.execute": 8.0, "service.reply": 1.0,
    "queue.store": 3.0, "service.store": 6.0,
}


def scripted_op(tr, i, base_ns=1_000_000_000, exec_extra_ns=0):
    rec = tr.op_begin()
    t0 = base_ns + i * 50_000_000
    tr.op_meta(rec, op=i, client=7, request=i, operation=130, n_events=8190)
    for idx, off in SCRIPT:
        extra = exec_extra_ns if idx >= tr.OP_EXEC_END else 0
        tr.op_stamp(rec, idx, t0 + off + extra)
    tr.op_finish(rec)
    tr.op_store_done(rec)
    return rec


def _quiet(t):
    t.configure_flight(latency_mult=8.0, stall_ms=2000.0, min_ops=64,
                       max_dumps=3, cooldown_s=5.0, directory="",
                       ring=t.OP_RING_DEFAULT)


@pytest.fixture
def traced():
    """Both tracers enabled, reset, with a quiet flight policy."""
    was = [t.enabled() for t in BOTH]
    for t in BOTH:
        t.reset()
        t.enable()
        _quiet(t)
    yield
    for t, on in zip(BOTH, was):
        _quiet(t)
        t.reset()
        if not on:
            t.disable()


def clock_free(summary):
    """A lifecycle summary without what follows the host clock."""
    s = json.loads(json.dumps(summary))
    for k in ("window_s", "occupancy"):
        s.pop(k)
    s["flat"] = {k: v for k, v in s["flat"].items() if not k.startswith("occupancy_")}
    return s


# --- exact decomposition --------------------------------------------------------


def test_scripted_decomposition_exact(traced):
    for t in BOTH:
        for i in range(5):
            scripted_op(t, i)
    s = tracer.lifecycle_summary()
    assert clock_free(s) == clock_free(ref_tracer.lifecycle_summary())
    assert s["ops"] == 5
    for name, want in EXPECT_MS.items():
        assert s["components"][name]["mean_ms"] == pytest.approx(want), name
    window = sum(s["components"][n]["mean_ms"] for n in EXPECT_MS if ".store" not in n)
    assert s["perceived"]["mean_ms"] == pytest.approx(18.0)
    assert window == pytest.approx(18.0)
    assert s["flat"]["queue_wait_total_ms"] == pytest.approx(4.5)
    assert s["flat"]["service_total_ms"] == pytest.approx(13.5)
    assert s["flat"]["lifecycle_perceived_p50_ms"] == pytest.approx(18.0, rel=0.13)


@pytest.mark.parametrize("samples", [(1, 2, 3, 4, 4, 4), ()], ids=["depths", "none"])
def test_commit_inflight_flat_keys(traced, samples):
    """The commit window's depth samples give commit_inflight_mean / max
    / p99 and the configured depth; without samples the keys are absent
    rather than zeros."""
    for t in BOTH:
        for d in samples:
            t.observe("pipeline.commit.inflight_depth", d)
        if samples:
            t.gauge("pipeline.commit.depth_config", 4)
    flat = tracer.lifecycle_summary()["flat"]
    assert flat == ref_tracer.lifecycle_summary()["flat"]
    if samples:
        assert flat["commit_inflight_mean"] == pytest.approx(3.0)
        assert flat["commit_inflight_max"] == 4
        assert flat["commit_inflight_p99"] == pytest.approx(4.0, rel=0.13)
        assert flat["commit_depth"] == 4.0
    else:
        assert "commit_inflight_mean" not in flat and "commit_depth" not in flat


def test_partial_stamps_skip_components(traced):
    """A journal-path op (no arrival, no reply) contributes only the
    components whose both stamps landed, and not to the totals."""
    for t in BOTH:
        rec = t.op_begin()
        t.op_stamp(rec, t.OP_COMMIT_SUBMIT, 1_000_000)
        t.op_stamp(rec, t.OP_EXEC_START, 2_000_000)
        t.op_stamp(rec, t.OP_EXEC_END, 5_000_000)
        t.op_finish(rec)
    s = tracer.lifecycle_summary()
    assert clock_free(s) == clock_free(ref_tracer.lifecycle_summary())
    assert s["components"]["queue.commit"]["mean_ms"] == pytest.approx(1.0)
    assert s["components"]["service.execute"]["mean_ms"] == pytest.approx(3.0)
    assert "queue.request" not in s["components"]
    assert s["perceived"]["count"] == 0
    assert "queue_wait_total_ms" not in s["flat"] and "service_total_ms" not in s["flat"]


@pytest.mark.parametrize("t", BOTH, ids=IDS)
def test_finish_is_idempotent_and_stamp_first(traced, t):
    rec = t.op_begin()
    t.op_stamp(rec, t.OP_ARRIVE, 1000)
    t.op_stamp(rec, t.OP_REPLY, 2000)
    t.op_finish(rec)
    t.op_finish(rec)  # a double completion must not recount
    assert t.lifecycle_summary()["ops"] == 1
    rec2 = t.op_begin()
    t.op_stamp(rec2, t.OP_EXEC_START, 5000)
    t.op_stamp_first(rec2, t.OP_EXEC_START)
    assert rec2.t[t.OP_EXEC_START] == 5000
    t.op_clear(rec2, t.OP_EXEC_START)
    t.op_stamp_first(rec2, t.OP_EXEC_START)
    assert rec2.t[t.OP_EXEC_START] > 5000


def test_occupancy_littles_law(traced):
    """Occupancy = component time / summary window: 2 ops of 18 ms
    perceived across a ~200 ms window."""
    import time as _time

    t0 = _time.perf_counter_ns()
    scripted_op(tracer, 0, base_ns=t0)
    _time.sleep(0.2)
    scripted_op(tracer, 1, base_ns=t0 + 150_000_000)
    s = tracer.lifecycle_summary()
    assert s["window_s"] >= 0.19
    occ = s["occupancy"]
    assert occ["total"] == pytest.approx(0.036 / s["window_s"], rel=0.2)
    assert occ["execute"] == pytest.approx(0.018 / s["window_s"], rel=0.2)
    text = tracer.prometheus_text()
    assert 'tbtpu_gauge{name="op.occupancy.total"}' in text


# --- flight recorder ------------------------------------------------------------


def _trip(t, kind, tmp):
    """Trip the recorder by `kind`; returns the dump path the trip wrote."""
    if kind == "latency":
        t.configure_flight(latency_mult=2.0, min_ops=4, directory=tmp, max_dumps=2)
        t.device_mem_set("balances", 8192)
        tok = t.device_dispatch("create_transfers_fast", h2d_bytes=256)
        for i in range(8):
            scripted_op(t, i)
        assert t.lifecycle_summary()["flight"]["dumps"] == 0
        scripted_op(t, 8, exec_extra_ns=500_000_000)  # ~28x the running p99
        t.device_finish("create_transfers_fast", tok)
    elif kind == "stall":
        t.configure_flight(stall_ms=100.0, directory=tmp)
        scripted_op(t, 0, exec_extra_ns=300_000_000)  # 308 ms > 100 ms
    else:
        t.configure_flight(directory=tmp)
        scripted_op(t, 0)
        assert t.flight_exception("RuntimeError('stage died')") is not None
    assert t.lifecycle_summary()["flight"]["dumps"] == 1
    (path,) = glob.glob(f"{tmp}/{STEM[t]}_*_1.json")
    return path


@pytest.mark.parametrize("kind", ["latency", "stall", "exception"])
def test_flight_trip_and_dump_schema(traced, tmp_path, kind):
    """Each trip rule dumps the op ring with the documented schema, the
    device block and a trace beside it; both packages' dumps agree but
    for the timestamps."""
    docs = []
    for t in BOTH:
        d = tmp_path / STEM[t]
        d.mkdir()
        path = _trip(t, kind, str(d))
        doc = json.loads(open(path).read())
        assert doc["reason"].startswith(f"{kind}:")
        trace = json.loads(open(path[:-len(".json")] + "_trace.json").read())
        assert "traceEvents" in trace
        doc.pop("tripped_ns")
        docs.append(doc)
    assert docs[0] == docs[1]
    doc = docs[0]
    if kind == "latency":
        assert len(doc["ops"]) == 9
        last = doc["ops"][-1]
        assert last["op"] == 8 and last["operation"] == 130 and last["n_events"] == 8190
        assert set(last["stamps"]) == set(tracer.OP_STAMP_NAMES)
        assert last["components"]["op.service.execute"] == pytest.approx(508.0)
        assert last["perceived_ms"] == pytest.approx(518.0)
        assert doc["device"] == {
            "inflight": {"create_transfers_fast": 1}, "window_depth": 1,
            "mem": {"balances": 8192}, "mem_total_bytes": 8192,
            "mem_high_water_bytes": 8192}
    else:
        assert doc["ops"]


@pytest.mark.parametrize("t", BOTH, ids=IDS)
def test_flight_dump_rate_limit(traced, tmp_path, t):
    t.configure_flight(directory=str(tmp_path), max_dumps=2, cooldown_s=0.0)
    for _ in range(5):
        t.flight_exception("boom")
    assert len(list(tmp_path.glob(f"{STEM[t]}_*.json"))) == 2 * 2  # + a trace each
    assert t.lifecycle_summary()["flight"]["exception_dumps"] == 5
    assert t.snapshot()["mark.flight_dump"]["count"] == 2


@pytest.mark.parametrize("t", BOTH, ids=IDS)
def test_ring_recycles_only_released_records(traced, t):
    """An evicted record a store thread still holds is not recycled; a
    released one is; a ring of 0 clamps to one record."""
    t.configure_flight(ring=1)

    def finish_only(i):
        rec = t.op_begin()
        t.op_stamp(rec, t.OP_ARRIVE, 1000 + i)
        t.op_stamp(rec, t.OP_REPLY, 2000 + i)
        t.op_finish(rec)
        return rec

    a = finish_only(0)
    finish_only(1)  # evicts a (unreleased: left to the collector)
    assert t.op_begin() is not a
    b = finish_only(2)
    t.op_store_done(b)
    finish_only(3)  # evicts b: pooled
    assert t.op_begin() is b
    t.configure_flight(ring=0)
    scripted_op(t, 0)
    assert len(t.flight_records()) == 1


# --- disabled path and overhead ----------------------------------------------------


def test_disabled_lifecycle_is_allocation_free():
    import gc

    was = tracer.enabled()
    tracer.disable()
    tracer.reset()
    try:
        for _ in range(16):
            rec = tracer.op_begin()
            tracer.op_stamp(rec, tracer.OP_ARRIVE)
            tracer.op_finish(rec)
        gc.collect()
        before = sys.getallocatedblocks()
        for _ in range(2000):
            rec = tracer.op_begin()
            assert rec is None
            tracer.op_stamp(rec, tracer.OP_ARRIVE)
            tracer.op_stamp_first(rec, tracer.OP_EXEC_START)
            tracer.op_finish(rec)
            tracer.op_store_done(rec)
            assert tracer.device_dispatch("create_transfers_fast", 64) == 0
            tracer.device_finish("create_transfers_fast", 0)
            tracer.device_bytes(h2d=64)
            tracer.device_mem_release("balances")
            with tracer.device_step("create_transfers_fast"):
                pass
        delta = sys.getallocatedblocks() - before
        assert delta < 32, f"disabled lifecycle allocated {delta} blocks"
        assert tracer.snapshot() == {}
    finally:
        if was:
            tracer.enable()


def test_enabled_overhead_under_two_percent_of_batch():
    """The full per-op lifecycle (begin, 12 stamps, finalize, store
    components, anomaly check) stays under 2% of a 25 ms batch: 500 µs
    an op, the reference's bound."""
    import time as _time

    was = tracer.enabled()
    tracer.reset()
    tracer.enable()
    try:
        for i in range(50):  # warm the pools and the arena
            scripted_op(tracer, i)
        n = 300
        t0 = _time.perf_counter_ns()
        for i in range(n):
            rec = tracer.op_begin()
            tracer.op_meta(rec, op=i, client=1, operation=130, n_events=8190)
            for idx, _off in SCRIPT:
                tracer.op_stamp(rec, idx)
            tracer.op_finish(rec)
            tracer.op_store_done(rec)
        per_op_ns = (_time.perf_counter_ns() - t0) / n
        assert per_op_ns < 500_000, f"{per_op_ns / 1e3:.1f} µs/op"
    finally:
        tracer.reset()
        if not was:
            tracer.disable()


# --- device-step profiler ------------------------------------------------------------


@pytest.mark.parametrize("t", BOTH, ids=IDS)
def test_device_entry_names_are_manifest_checked(traced, t):
    """An entry the manifest has never heard of raises; a registered
    one records."""
    with pytest.raises(ValueError, match="unknown device entry"):
        t.device_step("mystery_kernel")
    with pytest.raises(ValueError, match="unknown device entry"):
        t.device_dispatch("mystery_kernel")
    t.register_device_entry("mesh_kernel_0")
    with t.device_step("mesh_kernel_0"):
        pass
    assert t.snapshot()["device.mesh_kernel_0"]["count"] == 1


def test_one_entry_list_for_the_tracer_and_synclint(traced):
    """The tracer admits exactly the manifest's KERNEL_ENTRIES (the list
    the host-sync pass reads) and their mesh names, and every entry the
    reference's manifest declares."""
    from tigerbeetle_tpu.tidy import manifest as ref_manifest
    from tigerbeetle_tpu_torch.tidy import manifest, synclint

    assert set(ref_manifest.JIT_ENTRIES) <= manifest.KERNEL_ENTRIES
    src = open(synclint.__file__).read()
    assert "manifest.KERNEL_ENTRIES" in src
    for e in sorted(manifest.KERNEL_ENTRIES):
        tracer._device_entry_check(e)
        tracer._device_entry_check(manifest.MESH_ENTRY_PREFIX + e)
    for bad in ("sharded.mystery", "sharded.", "sharded_mystery"):
        with pytest.raises(ValueError, match="unknown device entry"):
            tracer._device_entry_check(bad)


def test_mesh_state_machine_names_pass_the_check(traced):
    """The state machine on a mesh names its windows sharded.<entry>."""
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.constants import config_by_name
    from tigerbeetle_tpu_torch.models.state_machine import StateMachine
    from tigerbeetle_tpu_torch.parallel import sharding

    sm = StateMachine(config_by_name("test_min"),
                      mesh=sharding.make_mesh(["cpu"]))
    ev = np.zeros(2, dtype=types.ACCOUNT_DTYPE)
    ev["id_lo"] = [1, 2]
    ev["ledger"] = 1
    ev["code"] = 10
    assert len(sm.create_accounts(ev)) == 0
    tr = np.zeros(1, dtype=types.TRANSFER_DTYPE)
    tr["id_lo"] = 1
    tr["debit_account_id_lo"] = 1
    tr["credit_account_id_lo"] = 2
    tr["amount_lo"] = 5
    tr["ledger"] = 1
    tr["code"] = 1
    assert len(sm.create_transfers(tr)) == 0
    snap = tracer.snapshot()
    assert snap["device.sharded.register_accounts"]["count"] >= 1
    assert any(k.startswith("device.step.sharded.") or k.startswith("device.sharded.read")
               for k in snap)


def test_device_step_and_transfer_counters(traced):
    for t in BOTH:
        with t.device_step("read_balances"):
            pass
        t.device_bytes(h2d=1024, d2h=256)
        token = t.device_dispatch("create_transfers_fast", h2d_bytes=4096)
        assert token
        t.device_finish("create_transfers_fast", token, d2h_bytes=512)
    got, want = tracer.snapshot(), ref_tracer.snapshot()
    for key in ("device.read_balances", "device.step.create_transfers_fast",
                "device.create_transfers_fast.dispatches", "device.h2d_bytes",
                "device.d2h_bytes"):
        assert got[key]["count"] == want[key]["count"], key
    assert got["device.h2d_bytes"]["count"] == 1024 + 4096
    assert got["device.d2h_bytes"]["count"] == 256 + 512


def test_device_mem_release_and_abandoned_windows(traced):
    """device_mem_release drops an owner and its gauge and keeps the
    high-water; abandoned dispatch windows are evicted oldest first."""
    for t in BOTH:
        t.device_mem_set("balances", 1000)
        t.device_mem_adjust("compact_fold", 500)
        t.device_mem_adjust("compact_fold", -500)
        t.device_mem_release("compact_fold")
        t.device_mem_release("never.held")
        for _ in range(t._DEVICE_INFLIGHT_MAX + 8):
            t.device_dispatch("create_transfers_fast")
    got = tracer.device_mem_totals()
    assert got == ref_tracer.device_mem_totals() == {
        "owners": {"balances": 1000}, "total_bytes": 1000, "high_water_bytes": 1500}
    assert tracer.gauges() == ref_tracer.gauges() == {"device.mem.balances.bytes": 1000.0}
    assert tracer.device_inflight() == ref_tracer.device_inflight() == {
        "entries": {"create_transfers_fast": 64}, "window_depth": 64}


def test_device_step_wired_through_state_machine(traced):
    """The balance-access entries report device spans and bytes on the
    port's state machine (its CPU tensors run the kernels' plain
    versions)."""
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.constants import config_by_name
    from tigerbeetle_tpu_torch.models.state_machine import StateMachine

    sm = StateMachine(config_by_name("test_min"), device="cpu")
    ev = np.zeros(2, dtype=types.ACCOUNT_DTYPE)
    ev["id_lo"] = [1, 2]
    ev["ledger"] = 1
    ev["code"] = 10
    assert len(sm.create_accounts(ev)) == 0
    snap = tracer.snapshot()
    assert snap.get("device.register_accounts", {}).get("count", 0) >= 1
    assert snap.get("device.h2d_bytes", {}).get("count", 0) > 0


# --- live pipeline ---------------------------------------------------------------------


def test_lifecycle_on_serial_cluster(traced):
    """A real replica records the whole lifecycle: the same components,
    op count and flight records in both packages."""
    out = []
    for t, pkg, placement in ((tracer, "tigerbeetle_tpu_torch", cs.PORT_HOST),
                              (ref_tracer, "tigerbeetle_tpu", cs.REF_HOST)):
        ns = cs.package(pkg)
        cl = ns.Cluster(replica_count=1, **placement)
        c = cs.setup_client(cl)
        cs.do_request(cl, c, ns.Operation.CREATE_ACCOUNTS, ns.account_batch([1, 2, 3]))
        s = t.lifecycle_summary()
        assert s["ops"] >= 2
        for comp in ("queue.request", "service.wal", "service.execute",
                     "service.reply", "service.store"):
            assert comp in s["components"], comp
        window = sum(v["mean_ms"] for k, v in s["components"].items() if ".store" not in k)
        assert window == pytest.approx(s["perceived"]["mean_ms"], rel=0.10)
        recs = t.flight_records()
        assert recs[-1]["operation"] == int(ns.Operation.CREATE_ACCOUNTS)
        out.append((s["ops"], sorted(s["components"]),
                    [(r["op"], r["operation"], r["n_events"]) for r in recs]))
    assert out[0] == out[1]


def test_lifecycle_multithreaded_store_stamps(traced):
    """Store stamps written from another thread land in the record
    already filed in the ring."""
    for t in BOTH:
        rec = t.op_begin()
        for idx, off in SCRIPT[:9]:
            t.op_stamp(rec, idx, 1_000_000_000 + off)
        t.op_finish(rec)

        def store_side(t=t, rec=rec):
            t.op_stamp(rec, t.OP_STORE_SUBMIT, 1_017_100_000)
            t.op_stamp(rec, t.OP_STORE_START, 1_020_100_000)
            t.op_stamp(rec, t.OP_STORE_END, 1_026_100_000)
            t.op_store_done(rec)

        th = threading.Thread(target=store_side, name="store-test")
        th.start()
        th.join()
    s = tracer.lifecycle_summary()
    assert clock_free(s) == clock_free(ref_tracer.lifecycle_summary())
    assert s["components"]["service.store"]["mean_ms"] == pytest.approx(6.0)
    assert tracer.flight_records() == ref_tracer.flight_records()
    assert tracer.flight_records()[-1]["components"]["op.service.store"] == pytest.approx(6.0)


def test_trace_summary_ops_waterfall_of_a_cluster_dump(traced, tmp_path):
    """`trace_summary --ops` renders the flight dump of a live replica,
    and its default view the per-thread trace beside it."""
    tracer.configure_flight(directory=str(tmp_path))
    ns = cs.package("tigerbeetle_tpu_torch")
    cl = ns.Cluster(replica_count=1, **cs.PORT_HOST)
    c = cs.setup_client(cl)
    cs.do_request(cl, c, ns.Operation.CREATE_ACCOUNTS, ns.account_batch([1, 2, 3]))
    path = tracer.flight_exception("scripted")
    repo = __file__.rsplit("/tests/", 1)[0]
    for args in (["--ops", path], [path[:-len(".json")] + "_trace.json"]):
        out = subprocess.run([sys.executable, f"{repo}/tools/trace_summary.py", *args],
                             capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stderr
        assert ("critical-path ranking" if args[0] == "--ops" else "replica.execute") in out.stdout
