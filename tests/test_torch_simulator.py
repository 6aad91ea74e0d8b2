"""The port's VOPR against the reference package's, seed for seed.

One seed draws one schedule in both packages (cluster size, clients,
standbys, loss, crashes with torn writes, partitions, grid corruption,
primary-targeted crashes, standby promotion). Each seed runs through the
reference `Simulator(seed)` (numpy state machine) and the port's
`Simulator(seed, device="cpu")` (the kernels' plain versions): both must
pass, with the same fault log, the same audited op count and, on every
replica live at the end of both runs, the same commit checksum for every
op. Seed 7 and seed 15 are big-batch seeds (8190-event batches through
VSR). Also: the port's smoke set and the model-guided adversarial
replay, and the overlapped commit stage gating on a grid repair and a
checkpoint at commit depth 0 and 8.
"""

import pytest

from tigerbeetle_tpu import simulator as ref_sim
from tigerbeetle_tpu_torch import simulator as port_sim

# (seed, requests): the reference test's VOPR seeds at its request
# counts, and the smoke seeds not among them at the smoke's.
SEEDS = [
    (0, port_sim.SMOKE_REQUESTS),
    (1, 25),
    (2, port_sim.SMOKE_REQUESTS),
    (5, 25),
    (7, 25),
    (9, port_sim.SMOKE_REQUESTS),
    (12, 25),
    (14, 25),
    (15, 8),
    (24, 25),
]


def _summary(sim, rc):
    """What one finished VOPR run must agree on across packages."""
    return {
        "rc": rc,
        "replicas": sim.replica_count,
        "clients": sim.client_count,
        "standbys": sim.standby_count,
        "big_batches": sim.big_batches,
        "faults": list(sim.log),
        "requests_done": sim.workload.requests_done,
        "checked_ops": sim.workload.auditor.checked_ops,
        "largest_batch": sim.workload.largest_batch,
    }


def _checksums(sim):
    return {
        i: dict(r.commit_checksums)
        for i, r in enumerate(sim.cluster.replicas)
        if r is not None
    }


def _check_same_run(ref, port, ref_rc, port_rc):
    assert ref_rc == ref_sim.EXIT_PASS
    assert port_rc == port_sim.EXIT_PASS
    assert _summary(port, port_rc) == _summary(ref, ref_rc)
    ref_ck, port_ck = _checksums(ref), _checksums(port)
    assert sorted(port_ck) == sorted(ref_ck)
    for i, chain in ref_ck.items():
        assert port_ck[i] == chain, f"replica {i}: commit checksums differ"
    assert any(port_ck.values()), "no replica committed anything"


@pytest.mark.parametrize("seed,requests", SEEDS)
def test_vopr_seed_matches_reference(seed, requests):
    ref = ref_sim.Simulator(seed, requests=requests)
    ref_rc = ref.run()
    port = port_sim.Simulator(seed, requests=requests, device="cpu")
    port_rc = port.run()
    _check_same_run(ref, port, ref_rc, port_rc)
    if seed in (7, 15):
        assert port.big_batches
        assert port.workload.largest_batch == 8190


@pytest.mark.parametrize("requests", [port_sim.SMOKE_REQUESTS, 30])
def test_adversarial_replay_matches_reference(requests):
    """At the smoke's 12 requests the run ends before the schedule's
    first fault; at 30 its crash and partition fire."""
    ref = ref_sim.adversarial_simulator(requests)
    ref_rc = ref.run()
    port = port_sim.adversarial_simulator(requests, device="cpu")
    assert port.crash_at == ref.crash_at
    assert port.partition_at == ref.partition_at
    assert port.heal_at == ref.heal_at
    port_rc = port.run()
    _check_same_run(ref, port, ref_rc, port_rc)
    assert bool(port.log) == (requests > port_sim.SMOKE_REQUESTS)


def test_smoke_set_covers_chaos_schedules_and_passes():
    assert port_sim.SMOKE_SEEDS == ref_sim.SMOKE_SEEDS
    assert port_sim.ADVERSARIAL_SEED == ref_sim.ADVERSARIAL_SEED
    assert port_sim.run_smoke(device="cpu") == port_sim.EXIT_PASS


def test_main_takes_the_card_unless_told_otherwise(monkeypatch):
    """`--device` defaults to the card; with `--device cpu` the run
    takes the plain versions. Here the card is absent, so the default
    must fail (EXIT_CRASH) rather than fall back to the CPU."""
    import torch

    seen = []
    real = port_sim.Simulator

    def spy(seed, requests=30, verbose=False, device=None):
        seen.append(device)
        return real(seed, requests=requests, verbose=verbose, device=device)

    monkeypatch.setattr(port_sim, "Simulator", spy)
    assert port_sim.main(["2", "--device", "cpu", "--requests", "4"]) == 0
    rc = port_sim.main(["2", "--requests", "4"])
    assert seen == ["cpu", None]
    if not torch.cuda.is_available():
        assert rc == port_sim.EXIT_CRASH


@pytest.mark.parametrize(
    "device_query_index,commit_depth",
    [
        (False, 0),
        # Depth 8 on the device route (lazy query runs, the device fold):
        # where the split-phase window forms, the query fault parks the
        # stage mid-window and the reclaim abandons every dispatched
        # handle before the repair.
        (True, 8),
    ],
)
def test_overlap_stage_gates_on_grid_repair_and_checkpoint(
    device_query_index, commit_depth
):
    """The overlapped commit stage on the port: a grid block corrupted
    on a backup makes a committed query fault inside the executor stage
    while later ops are staged behind it; the cluster then crosses a
    checkpoint. Every replica must execute op, op+1, ... exactly once,
    repair the one block, and end with convergent commit chains and
    checkpoint trailers."""
    import numpy as np

    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.testing.cluster import (
        Cluster, account_batch, transfer_batch,
    )
    from tigerbeetle_tpu_torch.tidy import runtime as tidy_runtime
    from tigerbeetle_tpu_torch.vsr.header import Operation

    tidy_runtime.enable()
    cl = Cluster(
        replica_count=3, seed=77, overlap=True, device="cpu",
        device_query_index=device_query_index, commit_depth=commit_depth,
    )
    try:
        executed = {r.replica: [] for r in cl.replicas}
        events = {r.replica: [] for r in cl.replicas}
        for r in cl.replicas:
            orig = r.on_event

            def hook(kind, rep, _orig=orig):
                if kind == "commit":
                    executed[rep.replica].append(rep.last_committed_op)
                elif kind in ("grid_repair", "checkpoint"):
                    events[rep.replica].append(kind)
                _orig(kind, rep)

            r.on_event = hook

        c = cl.clients[100]
        c.register()
        cl.run_until(lambda: c.registered)

        def req(op, body):
            c.request(op, body)
            cl.run_until(lambda: c.idle, 60_000)
            return c.replies[-1]

        req(Operation.CREATE_ACCOUNTS, account_batch([1, 2]))
        i = 0
        while not all(
            r is not None and len(r.state_machine.transfer_log.blocks) > 0
            for r in cl.replicas
        ):
            req(Operation.CREATE_TRANSFERS, transfer_batch([
                dict(id=1 + i * 10 + k, debit_account_id=1,
                     credit_account_id=2, amount=1, ledger=1, code=1)
                for k in range(10)
            ]))
            i += 1
            assert i < 50
        backup = next(r for r in cl.replicas if r is not None and not r.is_primary)
        cl.quiesce()
        grid = backup.state_machine.grid
        block = backup.state_machine.transfer_log.blocks[0]
        cl.storages[backup.replica].write(
            grid._addr(block), b"\xde\xad" * (grid.block_size // 2)
        )
        cl.storages[backup.replica].sync()
        grid.drop_cache()
        f = np.zeros(1, dtype=types.ACCOUNT_FILTER_DTYPE)
        f["account_id_lo"] = 1
        f["limit"] = 100
        f["flags"] = 0x3
        c.request(Operation.GET_ACCOUNT_TRANSFERS, f.tobytes())
        cl.run_until(lambda: c.idle, 60_000)
        for j in range(24):
            req(Operation.CREATE_TRANSFERS, transfer_batch([
                dict(id=9000 + j, debit_account_id=1, credit_account_id=2,
                     amount=1, ledger=1, code=1),
            ]))
        target = max(r.commit_min for r in cl.replicas if r is not None)
        cl.run_until(
            lambda: backup._grid_repair is None
            and all(r.commit_min >= target for r in cl.replicas if r is not None),
            80_000,
        )
        cl.quiesce()
        assert "grid_repair" in events[backup.replica]
        assert grid.local_checksum(block) is not None
        assert all(
            r.superblock.state.op_checkpoint >= 16
            for r in cl.replicas if r is not None
        )
        for rep, ops in executed.items():
            assert ops == list(range(1, len(ops) + 1)), (
                f"replica {rep} executed out of order: {ops[-10:]}"
            )
        cl.check_state_convergence()
        assert cl.check_storage_convergence() >= 16
    finally:
        cl.close()
        tidy_runtime.disable()
