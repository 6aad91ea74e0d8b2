"""The port's replica against the reference package's, scenario for scenario.

Each scenario of the reference's single-replica and replicated cluster
tests (create and lookup, a reply durable across a dirty crash, restart
recovery, recovery from a checkpoint beyond the WAL, replicated
convergence, a crashed backup that rejoins, the account queries through
VSR, a corrupt grid block repaired from a peer) runs on the reference's cluster (numpy backend) and on the port's
(`device="cpu"`) with the same seed; the single-replica scenarios also
on the device route (the reference's jax backend, the port's
`device_query_index=True`). The serial simulator is
tick-reproducible, so the replies are compared byte for byte (headers
included) with every replica's commit checksums, beside the reference
test's own assertions on the port's answers.
"""

import numpy as np
import pytest

from cluster_scenarios import (
    PORT,
    PORT_DEVICE,
    PORT_HOST,
    REF_DEVICE,
    REF_HOST,
    REFERENCE,
    do_request,
    lookup_ids,
    package,
    setup_client,
    transfer_specs,
    u128_column,
)


def _lookup_one(ns, r, account_id: int):
    return r.state_machine.lookup_accounts(
        np.array([account_id], dtype=np.uint64), np.array([0], dtype=np.uint64)
    )


def _create_and_lookup(pkg, placement):
    ns = package(pkg)
    cl = ns.Cluster(replica_count=1, **placement)
    c = setup_client(cl)
    out = [do_request(cl, c, ns.Operation.CREATE_ACCOUNTS, ns.account_batch([1, 2]))]
    out.append(do_request(cl, c, ns.Operation.CREATE_TRANSFERS, ns.transfer_batch([
        dict(id=1, debit_account_id=1, credit_account_id=2, amount=100,
             ledger=1, code=1),
    ])))
    out.append(do_request(cl, c, ns.Operation.LOOKUP_ACCOUNTS, lookup_ids(ns.types, [1, 2])))
    return [m.to_bytes() for m in out], dict(cl.replicas[0].commit_checksums)


def _reply_durable_across_crash(pkg, placement):
    """A resent request after a dirty crash gets the byte-identical cached
    reply (rebuilt by WAL replay), not a re-execution."""
    ns = package(pkg)
    cl = ns.Cluster(replica_count=1, **placement)
    c = setup_client(cl)
    do_request(cl, c, ns.Operation.CREATE_ACCOUNTS, ns.account_batch([1, 2]))
    reply = do_request(cl, c, ns.Operation.CREATE_TRANSFERS, ns.transfer_batch(
        transfer_specs(1, 1, amount=7) + transfer_specs(1, 1, amount=9)
    ))
    cl.crash_replica(0, torn_write_probability=0.5)
    cl.restart_replica(0)
    cl.run_until(lambda: cl.replicas[0].status == "normal")
    sess = cl.replicas[0].clients.get(c.id)
    assert sess is not None and sess.reply is not None
    assert sess.request == c.request_number
    assert sess.reply.to_bytes() == reply.to_bytes()
    return [reply.to_bytes()], dict(cl.replicas[0].commit_checksums)


def _restart_recovers_state(pkg, placement):
    ns = package(pkg)
    cl = ns.Cluster(replica_count=1, **placement)
    c = setup_client(cl)
    do_request(cl, c, ns.Operation.CREATE_ACCOUNTS, ns.account_batch([1, 2]))
    do_request(cl, c, ns.Operation.CREATE_TRANSFERS,
               ns.transfer_batch(transfer_specs(7, 1, amount=55)))
    cl.storages[0].sync()
    cl.crash_replica(0)
    cl.restart_replica(0)
    r0 = cl.replicas[0]
    assert r0.commit_min >= 3  # register + 2 ops re-executed
    out = _lookup_one(ns, r0, 1)
    assert ns.types.u128_of(out[0], "debits_posted") == 55
    return [out.tobytes()], dict(r0.commit_checksums)


def _checkpoint_and_recovery_beyond_wal(pkg, placement):
    """Past checkpoint_interval (16 in TEST_MIN): recovery starts from the
    checkpoint, then replays the WAL."""
    ns = package(pkg)
    cl = ns.Cluster(replica_count=1, **placement)
    c = setup_client(cl)
    do_request(cl, c, ns.Operation.CREATE_ACCOUNTS, ns.account_batch([1, 2]))
    for i in range(20):
        do_request(cl, c, ns.Operation.CREATE_TRANSFERS,
                   ns.transfer_batch(transfer_specs(10 + i, 1, amount=1)))
    r0 = cl.replicas[0]
    assert r0.superblock.state.op_checkpoint >= 16
    digests = cl._section_digests(cl._trailer_sections(r0))
    cl.storages[0].sync()
    cl.crash_replica(0)
    cl.restart_replica(0)
    r0 = cl.replicas[0]
    out = _lookup_one(ns, r0, 1)
    assert ns.types.u128_of(out[0], "debits_posted") == 20
    return [out.tobytes(), repr(sorted(digests.items()))], dict(r0.commit_checksums)


SINGLE = {
    "create_and_lookup": _create_and_lookup,
    "reply_durable_across_crash": _reply_durable_across_crash,
    "restart_recovers_state": _restart_recovers_state,
    "checkpoint_and_recovery_beyond_wal": _checkpoint_and_recovery_beyond_wal,
}


ROUTES = {"host": (REF_HOST, PORT_HOST), "device": (REF_DEVICE, PORT_DEVICE)}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("scenario", list(SINGLE))
def test_single_replica_matches_reference(scenario, route):
    ref_placement, port_placement = ROUTES[route]
    got = SINGLE[scenario](PORT, port_placement)
    want = SINGLE[scenario](REFERENCE, ref_placement)
    assert got[1] and got[1] == want[1]
    assert got[0] == want[0]


def test_create_and_lookup_balances():
    ns = package(PORT)
    replies, _ = _create_and_lookup(PORT, PORT_HOST)
    body = replies[2][256:]  # past the 256-byte header
    accounts = np.frombuffer(bytearray(body), dtype=ns.types.ACCOUNT_DTYPE)
    assert len(accounts) == 2
    assert u128_column(accounts, ns.types, "debits_posted") == [100, 0]
    assert u128_column(accounts, ns.types, "credits_posted") == [0, 100]


def _replicated_convergence(pkg, placement, n):
    ns = package(pkg)
    cl = ns.Cluster(replica_count=n, **placement)
    c = setup_client(cl)
    replies = [do_request(cl, c, ns.Operation.CREATE_ACCOUNTS, ns.account_batch([1, 2]))]
    for i in range(5):
        replies.append(do_request(cl, c, ns.Operation.CREATE_TRANSFERS,
                                  ns.transfer_batch(transfer_specs(1 + i, 1, amount=10))))
    cl.run_until(lambda: all(r.commit_min >= 7 for r in cl.replicas), 30_000)
    assert cl.check_state_convergence() >= 7
    return [m.to_bytes() for m in replies], [dict(r.commit_checksums) for r in cl.replicas]


@pytest.mark.parametrize("n", [2, 3, 5])
def test_replicated_commit_convergence(n):
    got = _replicated_convergence(PORT, PORT_HOST, n)
    want = _replicated_convergence(REFERENCE, REF_HOST, n)
    assert got == want


def _crashed_backup_rejoins(pkg, placement):
    ns = package(pkg)
    cl = ns.Cluster(replica_count=3, **placement)
    c = setup_client(cl)
    do_request(cl, c, ns.Operation.CREATE_ACCOUNTS, ns.account_batch([1, 2]))
    bi = next(r for r in cl.replicas if not r.is_primary).replica
    cl.storages[bi].sync()
    cl.crash_replica(bi)
    replies = []
    for i in range(4):
        replies.append(do_request(cl, c, ns.Operation.CREATE_TRANSFERS,
                                  ns.transfer_batch(transfer_specs(1 + i, 1, amount=10))))
    cl.restart_replica(bi)
    cl.run_until(lambda: all(r.commit_min >= 6 for r in cl.replicas), 60_000)
    assert cl.check_state_convergence() >= 6
    return [m.to_bytes() for m in replies], [dict(r.commit_checksums) for r in cl.replicas]


def test_crashed_backup_rejoins():
    assert _crashed_backup_rejoins(PORT, PORT_HOST) == _crashed_backup_rejoins(
        REFERENCE, REF_HOST
    )


def _query_ops_through_vsr(pkg, placement):
    """get_account_transfers and get_account_history over the replicated
    path."""
    ns = package(pkg)
    cl = ns.Cluster(replica_count=3, seed=31, **placement)
    c = setup_client(cl)
    do_request(cl, c, ns.Operation.CREATE_ACCOUNTS,
               ns.account_batch([1], flags=int(ns.flags.AccountFlags.HISTORY)))
    do_request(cl, c, ns.Operation.CREATE_ACCOUNTS, ns.account_batch([2]))
    for i in range(5):
        do_request(cl, c, ns.Operation.CREATE_TRANSFERS,
                   ns.transfer_batch(transfer_specs(1 + i, 1, amount=10 * (i + 1))))
    f = np.zeros(1, dtype=ns.types.ACCOUNT_FILTER_DTYPE)
    f["account_id_lo"] = 1
    f["limit"] = 10
    f["flags"] = 0x3  # debits | credits
    transfers = do_request(cl, c, ns.Operation.GET_ACCOUNT_TRANSFERS, f.tobytes())
    history = do_request(cl, c, ns.Operation.GET_ACCOUNT_HISTORY, f.tobytes())
    return transfers.to_bytes(), history.to_bytes()


def test_query_ops_through_vsr():
    ns = package(PORT)
    got = _query_ops_through_vsr(PORT, PORT_HOST)
    recs = np.frombuffer(bytearray(got[0][256:]), dtype=ns.types.TRANSFER_DTYPE)
    assert u128_column(recs, ns.types, "amount") == [10, 20, 30, 40, 50]
    rows = np.frombuffer(bytearray(got[1][256:]), dtype=ns.types.ACCOUNT_BALANCE_DTYPE)
    # Running debits_posted after each transfer: 10, 30, 60, 100, 150.
    assert u128_column(rows, ns.types, "debits_posted") == [10, 30, 60, 100, 150]
    assert got == _query_ops_through_vsr(REFERENCE, REF_HOST)


def test_replica_without_device_raises_on_a_host_without_cuda():
    """No fallback: device=None means the card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid here")
    ns = package(PORT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ns.Cluster(replica_count=1)


def _corrupt_block_repaired_from_peer(pkg, placement, **pipeline):
    """The reference's normal-operation grid repair: a backup's object-log
    block is smashed in storage; the next committed query reads it on
    every replica, the backup faults, fetches the block from a peer,
    rewrites it in place and keeps committing."""
    ns = package(pkg)
    cl = ns.Cluster(replica_count=3, seed=77, **placement, **pipeline)
    try:
        c = setup_client(cl)
        do_request(cl, c, ns.Operation.CREATE_ACCOUNTS, ns.account_batch([1, 2]))
        i = 0
        while not all(len(r.state_machine.transfer_log.blocks) for r in cl.replicas):
            do_request(cl, c, ns.Operation.CREATE_TRANSFERS,
                       ns.transfer_batch(transfer_specs(1 + i * 10, 10, amount=1)))
            i += 1
            assert i < 50
        cl.quiesce()
        backup = next(r for r in cl.replicas if not r.is_primary)
        grid = backup.state_machine.grid
        block = backup.state_machine.transfer_log.blocks[0]
        cl.storages[backup.replica].write(grid._addr(block), b"\xde\xad" * (grid.block_size // 2))
        cl.storages[backup.replica].sync()
        grid.drop_cache()
        assert grid.local_checksum(block) is None
        f = np.zeros(1, dtype=ns.types.ACCOUNT_FILTER_DTYPE)
        f["account_id_lo"] = 1
        f["limit"] = 100
        f["flags"] = 0x3
        reply = do_request(cl, c, ns.Operation.GET_ACCOUNT_TRANSFERS, f.tobytes())
        target = max(r.commit_min for r in cl.replicas)
        cl.run_until(lambda: backup._grid_repair is None and backup.commit_min >= target, 40_000)
        assert grid.local_checksum(block) is not None
        for k in range(20):
            do_request(cl, c, ns.Operation.CREATE_TRANSFERS,
                       ns.transfer_batch(transfer_specs(5000 + k, 1, amount=1)))
        target = max(r.commit_min for r in cl.replicas)
        cl.run_until(lambda: all(r.commit_min >= target for r in cl.replicas), 40_000)
        cl.quiesce()
        cl.check_state_convergence()
        assert cl.check_storage_convergence() >= 16
        return bytes(reply.body), [dict(r.commit_checksums) for r in cl.replicas]
    finally:
        cl.close()


@pytest.mark.parametrize("store_async", [False, True])
def test_corrupt_block_repaired_from_peer(store_async):
    got = _corrupt_block_repaired_from_peer(PORT, PORT_HOST, store_async=store_async)
    want = _corrupt_block_repaired_from_peer(REFERENCE, REF_HOST, store_async=store_async)
    assert got[0] == want[0]
    sums: dict = {}
    for chain in got[1] + want[1]:  # every replica of both runs, op for op
        for op, v in chain.items():
            assert sums.setdefault(op, v) == v, f"commit checksums differ at op {op}"


def _state_sync_of_a_lagging_backup(pkg, placement, **pipeline):
    """The reference's chunked state sync: a crashed backup falls further
    behind than the WAL ring holds (32 slots at TEST_MIN), restarts and
    installs the primary's checkpoint. Returns the synced backup's
    lookup, the chains and its checksum floor."""
    ns = package(pkg)
    cl = ns.Cluster(replica_count=3, seed=21, **placement, **pipeline)
    try:
        c = setup_client(cl)
        bi = next(r for r in cl.replicas if not r.is_primary).replica
        cl.storages[bi].sync()
        cl.crash_replica(bi)
        ids = list(range(1, 121))
        for i in range(0, len(ids), 20):
            do_request(cl, c, ns.Operation.CREATE_ACCOUNTS, ns.account_batch(ids[i:i + 20]))
        for b in range(28):
            do_request(cl, c, ns.Operation.CREATE_TRANSFERS, ns.transfer_batch([
                dict(id=1000 + b * 20 + k, debit_account_id=1 + (k % 120),
                     credit_account_id=1 + ((k + 1) % 120), amount=1 + k,
                     ledger=1, code=1)
                for k in range(20)
            ]), 40_000)
        cl.restart_replica(bi)
        target = max(r.commit_min for r in cl.replicas if r is not None)
        cl.run_until(lambda: cl.replicas[bi].commit_min >= target, 120_000)
        cl.quiesce()
        cl.check_state_convergence()
        rb = cl.replicas[bi]
        out = rb.state_machine.lookup_accounts(
            np.arange(1, 121, dtype=np.uint64), np.zeros(120, dtype=np.uint64)
        )
        return out.tobytes(), [dict(r.commit_checksums) for r in cl.replicas], rb.checksum_floor
    finally:
        cl.close()


@pytest.mark.parametrize("route", list(ROUTES))
def test_state_sync_of_a_lagging_backup(route, monkeypatch):
    """The install builds a second machine beside the old one, then
    releases the old one's device state and retires its entries in the
    device memory ledger, where every machine counts apart; with the
    async store stage the new machine takes the stage over."""
    from tigerbeetle_tpu_torch import tracer
    from tigerbeetle_tpu_torch.models.state_machine import StateMachine

    released, ledgers = [], []
    release = StateMachine.release

    def counted(sm):
        released.append(sm)
        ledgers.append(dict(tracer._device_mem))
        release(sm)
        ledgers.append(dict(tracer._device_mem))

    monkeypatch.setattr(StateMachine, "release", counted)
    ref_placement, port_placement = ROUTES[route]
    tracer.reset()
    tracer.enable()
    try:
        got = _state_sync_of_a_lagging_backup(PORT, port_placement, store_async=True)
    finally:
        tracer.disable()
        tracer.reset()
    want = _state_sync_of_a_lagging_backup(REFERENCE, ref_placement, store_async=True)
    assert got[2] >= 16  # the backup's state came from a checkpoint install
    assert len(released) == 1 and released[0].state is None
    tag = released[0]._mem_tag + "."
    before, after = ledgers
    assert tag + "balances" in before and not any(o.startswith(tag) for o in after)
    balances = [o for o in after if o.endswith(".balances")]
    assert len(balances) >= 3 and len(set(after[o] for o in balances)) == 1
    assert got[0] == want[0] and got[2] == want[2]
    sums: dict = {}
    for chain in got[1] + want[1]:
        for op, v in chain.items():
            assert sums.setdefault(op, v) == v, f"commit checksums differ at op {op}"
