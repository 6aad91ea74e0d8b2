"""The replica's pipeline against the reference package's, op for op.

The same 3-replica workload (seed 9, frozen time, 40 create_transfers
batches past two TEST_MIN checkpoints) runs through the reference
cluster, which writes a hash log of replica 0's commit checksums, and
through the port's cluster on the CPU, which checks that log as it
commits: serial, with the commit executor (overlap), with the async
store stage, and with both. Every replica's commit checksum chain, every
checkpoint's trailer section digests and every reply must be the
reference's. The host route is held against the reference's numpy
backend; the device route (the kernels' plain versions, lazy query runs,
the device fold) against its jax backend.
"""

import contextlib
import threading

import numpy as np
import pytest

from cluster_scenarios import (
    PORT,
    PORT_DEVICE,
    PORT_HOST,
    REF_DEVICE,
    REF_HOST,
    REFERENCE,
    catch_up,
    check_runs_identical,
    do_request,
    drive_pipeline,
    lookup_ids,
    package,
    setup_client,
    transfer_specs,
)

OPS = 40
WANT = OPS + 2  # register + create_accounts + the transfer batches

MODES = {
    "serial": {},
    "overlap": dict(overlap=True),
    "store_async": dict(store_async=True),
    "overlap_store_async": dict(overlap=True, store_async=True),
}


def _reference_run(tmp_path_factory, name, placement):
    ns = package(REFERENCE)
    path = str(tmp_path_factory.mktemp("hash_log") / f"{name}.log")
    log = ns.HashLog(path, "create")
    run = drive_pipeline(REFERENCE, ops=OPS, hash_log=log, **placement)
    log.close()
    return run, path


@pytest.fixture(scope="module")
def reference_host(tmp_path_factory):
    return _reference_run(tmp_path_factory, "host", REF_HOST)


@pytest.fixture(scope="module")
def reference_device(tmp_path_factory):
    return _reference_run(tmp_path_factory, "device", REF_DEVICE)


def _port_run(path, placement, **mode):
    ns = package(PORT)
    check = ns.HashLog(path, "check")
    run = drive_pipeline(PORT, ops=OPS, hash_log=check, **mode, **placement)
    check.close()
    return run


@pytest.mark.parametrize("mode", list(MODES))
def test_pipeline_matches_reference_host_route(reference_host, mode):
    ref, path = reference_host
    check_runs_identical(WANT, ref, _port_run(path, PORT_HOST, **MODES[mode]))


@pytest.mark.parametrize("mode", ["serial", "overlap_store_async", "overlap_depth8"])
def test_pipeline_matches_reference_device_route(reference_device, mode):
    """The device query-index route both ways (reference jax backend,
    port device_query_index=True); depth 8 is the protocol's full
    cross-batch dispatch window."""
    ref, path = reference_device
    kw = dict(overlap=True, commit_depth=8) if mode == "overlap_depth8" else MODES[mode]
    check_runs_identical(WANT, ref, _port_run(path, PORT_DEVICE, **kw))


def _read_your_writes(pkg, placement):
    """The reference's read-your-writes scenario: the store worker is
    frozen by holding its condition (the sim thread can still submit, a
    barrier's wait releases it). Returns the three replies' bodies and
    whether the store jobs were still queued after the first."""
    ns = package(pkg)
    cl = ns.Cluster(replica_count=1, seed=5, store_async=True, **placement)
    try:
        c = setup_client(cl)
        do_request(cl, c, ns.Operation.CREATE_ACCOUNTS, ns.account_batch([1, 2]))
        se = cl.replicas[0].store_executor
        out = []
        with se._cond:
            out.append(bytes(do_request(
                cl, c, ns.Operation.CREATE_TRANSFERS,
                ns.transfer_batch(transfer_specs(10, 3, amount=5)),
            ).body))
            queued = bool(se.unapplied_stores())
            # Id 11 again while its store is still queued: found in the
            # pending write buffer.
            out.append(bytes(do_request(
                cl, c, ns.Operation.CREATE_TRANSFERS,
                ns.transfer_batch(transfer_specs(11, 1, amount=5)),
            ).body))
            # The lookup's store_barrier drains the stage first.
            out.append(bytes(do_request(
                cl, c, ns.Operation.LOOKUP_TRANSFERS,
                lookup_ids(ns.types, [10, 11, 12]),
            ).body))
        cl.quiesce()
        cl.check_state_convergence()
        return out, queued
    finally:
        cl.close()


@pytest.mark.parametrize("route", ["host", "device"])
def test_read_your_writes_with_store_jobs_queued(route):
    ref_placement, port_placement = (
        (REF_HOST, PORT_HOST) if route == "host" else (REF_DEVICE, PORT_DEVICE)
    )
    want, _ = _read_your_writes(REFERENCE, ref_placement)
    got, queued = _read_your_writes(PORT, port_placement)
    ns = package(PORT)
    assert queued, "the store job must still be queued after the reply"
    assert np.frombuffer(got[0], ns.types.EVENT_RESULT_DTYPE).size == 0
    res = np.frombuffer(got[1], ns.types.EVENT_RESULT_DTYPE)
    assert len(res) == 1 and res[0]["result"] == int(ns.results.CreateTransferResult.EXISTS)
    recs = np.frombuffer(got[2], ns.types.TRANSFER_DTYPE)
    assert [int(x) for x in recs["id_lo"]] == [10, 11, 12]
    assert got == want


def _checkpoint_with_jobs_queued(pkg, placement):
    """The reference's checkpoint-drain scenario: every replica's store
    worker frozen while ops commit up to the first checkpoint, so the
    checkpoint's drain finds jobs and beats queued. Returns the
    checkpoint digests and replica 0's chain."""
    ns = package(pkg)
    cl = ns.Cluster(replica_count=3, seed=21, store_async=True, **placement)
    try:
        c = setup_client(cl)
        do_request(cl, c, ns.Operation.CREATE_ACCOUNTS, ns.account_batch([1, 2]))
        interval = cl.config.checkpoint_interval
        piled = False
        with contextlib.ExitStack() as stack:
            for r in cl.replicas:
                stack.enter_context(r.store_executor._cond)
            i = 0
            while cl.replicas[0].superblock.state.op_checkpoint < interval:
                do_request(cl, c, ns.Operation.CREATE_TRANSFERS,
                           ns.transfer_batch(transfer_specs(100 + i * 4, 4)))
                i += 1
                if cl.replicas[0].commit_min < interval - 1:
                    piled |= any(
                        r.store_executor.unapplied_stores()
                        or not r.store_executor.idle for r in cl.replicas
                    )
        cl.run_until(lambda: all(
            r.superblock.state.op_checkpoint >= interval for r in cl.replicas
        ), 60_000)
        catch_up(cl)
        assert piled, "store jobs must pile up while the workers are frozen"
        assert cl.check_storage_convergence() >= interval
        assert cl.check_state_convergence() > 0
        return dict(cl._checkpoint_history), dict(cl.replicas[0].commit_checksums)
    finally:
        cl.close()


def test_checkpoint_drains_queued_store_jobs():
    want = _checkpoint_with_jobs_queued(REFERENCE, REF_HOST)
    got = _checkpoint_with_jobs_queued(PORT, PORT_HOST)
    assert got[0] == want[0]
    common = set(got[1]) & set(want[1])
    assert len(common) >= 16
    assert all(got[1][op] == want[1][op] for op in common)


def test_checkpoint_reads_balances_after_both_stages_drain():
    """The port's own guard for the shared pinned blocks of
    `_read_balances`: a checkpoint taken while store jobs are queued
    (each replica's store worker is held from a few ops before the
    boundary until the checkpoint drains it) and a dispatch window is
    open (commit executor, depth 4). The checkpoint reads the balances
    on the loop thread only after the store stage is idle and the window
    is empty, and no two threads are ever inside `_read_balances` at
    once."""
    ns = package(PORT)
    cl = ns.Cluster(replica_count=3, seed=21, overlap=True, store_async=True,
                    commit_depth=4, **PORT_DEVICE)
    inside = [0]
    seen = {"max_inside": 0, "window_max": 0, "queued_at_drain": [],
            "checkpoint_reads": 0, "bad": []}
    guard = threading.Lock()
    gates = []

    def wrap(r):
        sm, se = r.state_machine, r.store_executor
        gate = threading.Event()  # the store worker waits on it for a job
        gate.set()
        gates.append(gate)
        read, dispatch, process, drain = (
            sm._read_balances, sm.create_transfers_dispatch, se._process, se.drain,
        )

        def read_balances(slots):
            with guard:
                inside[0] += 1
                seen["max_inside"] = max(seen["max_inside"], inside[0])
            try:
                if threading.current_thread() is threading.main_thread():
                    # The loop thread reads only for a checkpoint here.
                    seen["checkpoint_reads"] += 1
                    if not se.idle or se.unapplied_stores():
                        seen["bad"].append("store stage busy")
                    if sm._ct_pending:
                        seen["bad"].append("dispatch window open")
                return read(slots)
            finally:
                with guard:
                    inside[0] -= 1

        def create_transfers_dispatch(events, timestamp):
            h = dispatch(events, timestamp)
            seen["window_max"] = max(seen["window_max"], len(sm._ct_pending))
            return h

        def gated_process(job):
            gate.wait()
            return process(job)

        def gated_drain():
            if not gate.is_set():
                seen["queued_at_drain"].append(len(se.unapplied_stores()))
                gate.set()
            drain()

        sm._read_balances = read_balances
        sm.create_transfers_dispatch = create_transfers_dispatch
        se._process = gated_process
        se.drain = gated_drain

    for r in cl.replicas:
        wrap(r)
    try:
        c = setup_client(cl)
        do_request(cl, c, ns.Operation.CREATE_ACCOUNTS, ns.account_batch([1, 2]))
        interval = cl.config.checkpoint_interval
        i = 0
        held = False
        while cl.replicas[0].superblock.state.op_checkpoint < interval:
            if not held and cl.replicas[0].commit_min >= interval - 5:
                held = True
                for g in gates:  # fewer jobs than the stage's queue holds
                    g.clear()
            do_request(cl, c, ns.Operation.CREATE_TRANSFERS,
                       ns.transfer_batch(transfer_specs(100 + i * 4, 4)))
            i += 1
        cl.run_until(lambda: all(
            r.superblock.state.op_checkpoint >= interval for r in cl.replicas
        ), 60_000)
        catch_up(cl)
        assert cl.check_storage_convergence() >= interval
        assert cl.check_state_convergence() > 0
    finally:
        for g in gates:
            g.set()
        cl.close()
    assert seen["checkpoint_reads"] >= 3, seen
    assert seen["queued_at_drain"] and min(seen["queued_at_drain"]) > 0, seen
    assert seen["window_max"] > 1, seen
    assert seen["max_inside"] == 1, seen
    assert not seen["bad"], seen


def _query_transfers_and_restart(pkg, placement):
    """The reference's query scenario: 24 single-transfer batches, a
    query_transfers through consensus, then a backup restarted past the
    checkpoint answers the same query from its restored index."""
    ns = package(pkg)
    cl = ns.Cluster(replica_count=3, seed=31, **placement)
    c = setup_client(cl)
    do_request(cl, c, ns.Operation.CREATE_ACCOUNTS, ns.account_batch([1, 2]))
    for i in range(24):
        do_request(cl, c, ns.Operation.CREATE_TRANSFERS, ns.transfer_batch([
            dict(id=1 + i, debit_account_id=1, credit_account_id=2,
                 amount=1, ledger=1, code=(i % 3) + 1,
                 user_data_64=100 + (i % 2)),
        ]))
    f = np.zeros(1, dtype=ns.types.QUERY_FILTER_DTYPE)
    f[0]["user_data_64"] = 100
    f[0]["code"] = 1
    f[0]["limit"] = 8190
    reply = bytes(do_request(cl, c, ns.Operation.QUERY_TRANSFERS, f.tobytes()).body)
    victim = next(r.replica for r in cl.replicas if not r.is_primary)
    assert cl.replicas[victim].superblock.state.op_checkpoint > 0
    cl.storages[victim].sync()
    cl.crash_replica(victim)
    cl.restart_replica(victim)
    restarted = cl.replicas[victim]
    target = max(r.commit_min for r in cl.replicas if r is not None)
    cl.run_until(lambda: restarted.commit_min >= target, 40_000)
    got = restarted.state_machine.query_transfers(f[0])
    cl.check_state_convergence()
    return reply, got.tobytes(), dict(restarted.commit_checksums)


@pytest.mark.parametrize("route", ["host", "device"])
def test_query_transfers_through_vsr_and_restart(route):
    ref_placement, port_placement = (
        (REF_HOST, PORT_HOST) if route == "host" else (REF_DEVICE, PORT_DEVICE)
    )
    want = _query_transfers_and_restart(REFERENCE, ref_placement)
    got = _query_transfers_and_restart(PORT, port_placement)
    ns = package(PORT)
    recs = np.frombuffer(got[0], ns.types.TRANSFER_DTYPE)
    # i % 3 == 0 (code 1) and i % 2 == 0 (ud64 100): i in 0, 6, 12, 18.
    assert [int(x) for x in recs["id_lo"]] == [1, 7, 13, 19]
    assert got[0] == want[0]
    assert got[1] == got[0]  # the restarted backup answers identically
    assert got[2] == want[2]


def _query_accounts(pkg, placement):
    ns = package(pkg)
    cl = ns.Cluster(replica_count=1, seed=32, **placement)
    c = setup_client(cl)
    arr = np.frombuffer(
        bytearray(ns.account_batch([1, 2, 3])), dtype=ns.types.ACCOUNT_DTYPE
    ).copy()
    arr["code"] = [10, 20, 10]
    do_request(cl, c, ns.Operation.CREATE_ACCOUNTS, arr.tobytes())
    f = np.zeros(1, dtype=ns.types.QUERY_FILTER_DTYPE)
    f[0]["code"] = 10
    f[0]["limit"] = 8190
    return bytes(do_request(cl, c, ns.Operation.QUERY_ACCOUNTS, f.tobytes()).body)


def test_query_accounts_through_vsr():
    got = _query_accounts(PORT, PORT_HOST)
    recs = np.frombuffer(got, dtype=package(PORT).types.ACCOUNT_DTYPE)
    assert [int(x) for x in recs["id_lo"]] == [1, 3]
    assert got == _query_accounts(REFERENCE, REF_HOST)


def test_tracing_on_changes_no_committed_byte(reference_host):
    """The op lifecycle (one record a prepare, stamped at every hand-off,
    its components in the span registry) and the device windows on,
    through the full pipeline: the chains, trailer digests and replies
    stay the reference's, every op of every replica is decomposed, and no
    pipeline exception tripped the flight recorder."""
    from tigerbeetle_tpu_torch import tracer

    ref, path = reference_host
    tracer.reset()
    tracer.enable()
    try:
        got = _port_run(path, PORT_DEVICE, overlap=True, store_async=True)
        snap = tracer.snapshot()
        exceptions = tracer.flight_exceptions()
        dumps = tracer.flight_dumps()
    finally:
        tracer.disable()
        tracer.reset()
    check_runs_identical(WANT, ref, got)
    assert exceptions == 0
    assert not [d for d in dumps if d["reason"].startswith("exception")]
    assert snap["op.perceived"]["count"] >= WANT  # the primary's, arrive to reply
    for event in ("op.service.execute", "op.service.store", "op.queue.commit"):
        assert snap[event]["count"] >= 3 * WANT, event  # every replica's ops
    assert snap["device.step.create_transfers_fast"]["count"] > 0
