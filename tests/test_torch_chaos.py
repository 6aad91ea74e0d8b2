"""The port's chaos layer: FileStorage fault injection held byte for
byte against the reference package's FileStorage, the torn-checkpoint
window, the recovery lifecycle stamps, the wall-clock scenario mode, the
seven in-process chaos scenarios and the two real-process ones, all on
the CPU (the kernels' plain versions; `cli start --device=cpu`).
"""

import os

import pytest

from tigerbeetle_tpu.io import storage as ref_storage
from tigerbeetle_tpu_torch.constants import SECTOR_SIZE
from tigerbeetle_tpu_torch.io import storage as port_storage
from tigerbeetle_tpu_torch.io.storage import FileStorage
from tigerbeetle_tpu_torch.testing import chaos
from tigerbeetle_tpu_torch.testing.chaos import ChaosCrash, ChaosHarness
from tigerbeetle_tpu_torch.testing.cluster import (
    Cluster,
    account_batch,
    transfer_batch,
)
from tigerbeetle_tpu_torch.vsr.header import Operation


def do_request(cluster, client, operation, body, max_ticks=20_000):
    client.request(operation, body)
    cluster.run_until(lambda: client.idle, max_ticks)
    return client.replies[-1]


def setup_client(cluster, cid=100):
    c = cluster.clients[cid]
    c.register()
    cluster.run_until(lambda: c.registered)
    return c


def cpu_cluster(**kw):
    return Cluster(device="cpu", **kw)


# --- FileStorage fault injection, byte-equal to the reference ------------


class _Twin:
    """The port's FileStorage and the reference's, on two files, driven
    by the same calls: every call's result must agree, and so must the
    two files' bytes when the twin closes."""

    def __init__(self, tmp_path, sectors=16, fi=True):
        self.paths = [str(tmp_path / "port.dat"), str(tmp_path / "ref.dat")]
        self.fs = [
            mod.FileStorage(
                path, size=sectors * SECTOR_SIZE, create=True,
                fault_injection=fi,
            )
            for mod, path in zip((port_storage, ref_storage), self.paths)
        ]

    def do(self, fn):
        port, ref = (fn(fs) for fs in self.fs)
        assert port == ref
        return port

    def read(self, offset, size):
        return self.do(lambda fs: fs.read(offset, size))

    def close(self):
        for fs in self.fs:
            fs.close()
        port, ref = (open(p, "rb").read() for p in self.paths)
        assert port == ref, "port and reference files differ"


@pytest.fixture
def twin(tmp_path):
    t = _Twin(tmp_path)
    yield t
    t.close()


class TestFileStorageFaultInjection:
    def test_gate_off_means_noop(self, tmp_path):
        t = _Twin(tmp_path, fi=False)
        t.do(lambda fs: fs.write(0, b"A" * SECTOR_SIZE))
        t.do(lambda fs: fs.crash(torn_write_probability=1.0))
        assert t.read(0, SECTOR_SIZE) == b"A" * SECTOR_SIZE
        t.do(lambda fs: fs.corrupt_sector(0))
        assert t.read(0, SECTOR_SIZE) == b"A" * SECTOR_SIZE
        t.close()

    def test_injection_is_off_unless_asked_for(self, tmp_path, monkeypatch):
        """Only the constructor argument turns injection on: the port
        reads no environment switch, so the reference's
        TIGERBEETLE_TPU_FAULT_INJECT leaves a default FileStorage
        fault-free."""
        monkeypatch.setenv("TIGERBEETLE_TPU_FAULT_INJECT", "1")
        fs = FileStorage(
            str(tmp_path / "env.dat"), size=4 * SECTOR_SIZE, create=True
        )
        assert not fs._fi
        fs.write(0, b"A" * SECTOR_SIZE)
        fs.crash(torn_write_probability=1.0)
        fs.corrupt_sector(0)
        assert fs.read(0, SECTOR_SIZE) == b"A" * SECTOR_SIZE
        fs.close()
        fs = FileStorage(
            str(tmp_path / "env1.dat"), size=4 * SECTOR_SIZE, create=True,
            fault_injection=True,
        )
        assert fs._fi
        fs.close()

    def test_crash_reverts_unsynced_buffered_writes(self, twin):
        twin.do(lambda fs: fs.write(0, b"A" * SECTOR_SIZE))
        twin.do(lambda fs: fs.sync())
        twin.do(lambda fs: fs.write(0, b"B" * SECTOR_SIZE))
        twin.do(lambda fs: fs.crash(torn_write_probability=1.0))
        assert twin.read(0, SECTOR_SIZE) == b"A" * SECTOR_SIZE

    def test_crash_spares_synced_writes(self, twin):
        twin.do(lambda fs: fs.write(0, b"C" * SECTOR_SIZE))
        twin.do(lambda fs: fs.sync())
        twin.do(lambda fs: fs.crash(torn_write_probability=1.0))
        assert twin.read(0, SECTOR_SIZE) == b"C" * SECTOR_SIZE

    def test_crash_spares_write_durable(self, twin):
        twin.do(lambda fs: fs.write(0, b"X" * SECTOR_SIZE))
        twin.do(lambda fs: fs.write_durable(0, [b"D" * SECTOR_SIZE]))
        twin.do(lambda fs: fs.crash(torn_write_probability=1.0))
        assert twin.read(0, SECTOR_SIZE) == b"D" * SECTOR_SIZE

    def test_write_batch_records_preimages(self, twin):
        twin.do(lambda fs: fs.write(0, b"S" * (2 * SECTOR_SIZE)))
        twin.do(lambda fs: fs.sync())
        twin.do(lambda fs: fs.write_batch(
            [(0, b"h" * 64), (64, b"b" * (SECTOR_SIZE - 64))]
        ))
        twin.do(lambda fs: fs.crash(torn_write_probability=1.0))
        assert twin.read(0, 2 * SECTOR_SIZE) == b"S" * (2 * SECTOR_SIZE)

    @pytest.mark.parametrize("rounds", [1, 6])
    def test_torn_crash_tears_at_sector_boundary(self, twin, rounds):
        """With torn_write_probability=0 every crashed write is applied
        but may tear: each sector is entirely old or new, and the new
        sectors form a prefix. The tear points come from the storage's
        seeded generator: the same in both packages."""
        old = bytes(range(256)) * (SECTOR_SIZE // 256)
        for r in range(rounds):
            for s in range(4):
                twin.do(lambda fs, s=s: fs.write(s * SECTOR_SIZE, old))
            twin.do(lambda fs: fs.sync())
            new = bytes([0x4E + r]) * (4 * SECTOR_SIZE)
            twin.do(lambda fs: fs.write(0, new))
            twin.do(lambda fs: fs.crash(torn_write_probability=0.0))
            got = twin.read(0, 4 * SECTOR_SIZE)
            states = []
            for s in range(4):
                sec = got[s * SECTOR_SIZE : (s + 1) * SECTOR_SIZE]
                assert sec in (old, new[:SECTOR_SIZE]), f"sector {s} is mixed"
                states.append(sec == new[:SECTOR_SIZE])
            assert states == sorted(states, reverse=True)

    def test_corrupt_and_repair_sector(self, twin):
        twin.do(lambda fs: fs.write(SECTOR_SIZE, b"G" * SECTOR_SIZE))
        twin.do(lambda fs: fs.sync())
        twin.do(lambda fs: fs.corrupt_sector(1))
        bad = twin.read(SECTOR_SIZE, SECTOR_SIZE)
        assert bad == bytes(b ^ 0xA5 for b in b"G" * SECTOR_SIZE)
        span = twin.read(0, 2 * SECTOR_SIZE)
        assert span[SECTOR_SIZE:] == bad
        twin.do(lambda fs: fs.repair_sector(1))
        assert twin.read(SECTOR_SIZE, SECTOR_SIZE) == b"G" * SECTOR_SIZE

    def test_crash_reverts_overlapping_unsynced_writes(self, twin):
        synced = bytes(range(256)) * (2 * SECTOR_SIZE // 256)
        twin.do(lambda fs: fs.write(0, synced))
        twin.do(lambda fs: fs.sync())
        twin.do(lambda fs: fs.write(0, b"U" * (2 * SECTOR_SIZE)))
        twin.do(lambda fs: fs.write(SECTOR_SIZE, b"V" * SECTOR_SIZE))
        twin.do(lambda fs: fs.crash(torn_write_probability=1.0))
        assert twin.read(0, 2 * SECTOR_SIZE) == synced

    def test_crash_reverts_size_growing_rewrite(self, twin):
        synced = b"S" * (2 * SECTOR_SIZE)
        twin.do(lambda fs: fs.write(0, synced))
        twin.do(lambda fs: fs.sync())
        twin.do(lambda fs: fs.write(0, b"a" * SECTOR_SIZE))
        twin.do(lambda fs: fs.write(0, b"b" * (2 * SECTOR_SIZE)))
        twin.do(lambda fs: fs.crash(torn_write_probability=1.0))
        assert twin.read(0, 2 * SECTOR_SIZE) == synced

    def test_replica_format_survives_crash_on_filestorage(self, tmp_path):
        from tigerbeetle_tpu_torch.constants import TEST_MIN
        from tigerbeetle_tpu_torch.io.storage import Zone
        from tigerbeetle_tpu_torch.vsr.replica import Replica
        from tigerbeetle_tpu_torch.vsr.superblock import SuperBlock

        zone = Zone.for_config(
            TEST_MIN.journal_slot_count, TEST_MIN.message_size_max,
            grid_block_count=TEST_MIN.grid_block_count,
            grid_block_size=TEST_MIN.lsm_block_size,
        )
        fs = FileStorage(
            str(tmp_path / "r.tigerbeetle"), size=zone.total_size,
            create=True, fault_injection=True,
        )
        Replica.format(fs, zone, 0xC1, 0, 1)
        fs.crash(torn_write_probability=1.0)
        st = SuperBlock(fs, zone).open()
        assert st.cluster == 0xC1 and st.replica == 0
        fs.close()


# --- wall-clock scenario mode (Cluster.run_wall) -------------------------


class TestRunWall:
    def test_schedule_fires_once_and_on_step_runs(self):
        cl = cpu_cluster(replica_count=1, seed=3)
        fired = []
        steps = []
        elapsed = cl.run_wall(
            0.08,
            schedule=[(0.02, lambda: fired.append("b")),
                      (0.0, lambda: fired.append("a"))],
            on_step=lambda e: steps.append(e),
        )
        assert elapsed >= 0.08
        assert fired == ["a", "b"]
        assert steps and steps == sorted(steps)

    def test_until_stops_early_and_step_fn_drives(self):
        cl = cpu_cluster(replica_count=1, seed=3)
        n = {"steps": 0}

        def step():
            n["steps"] += 1
            cl.step()

        elapsed = cl.run_wall(
            10.0, until=lambda: n["steps"] >= 5, step_fn=step
        )
        assert n["steps"] == 5
        assert elapsed < 10.0


# --- torn-checkpoint window (deterministic, each sector boundary) --------


class TestTornCheckpointWindow:
    """Crash between the trailer write and each superblock copy write
    (one copy = one sector; two sync'd waves of two): before the first
    wave's sync only the PRIOR superblock has a quorum; after it the new
    checkpoint is durable. Either way the replayed hash chain must be
    byte-identical to the pre-crash chain."""

    INTERVAL = 16  # TEST_MIN.checkpoint_interval

    def _drive_to_crash(self, crash_after_writes: int):
        cl = cpu_cluster(replica_count=1, seed=41)
        storage = cl.storages[0]
        zone = cl.zone
        r = cl.replicas[0]
        state = {"armed": False, "left": crash_after_writes}
        orig_write = storage.write

        def guarded_write(offset, data):
            if (
                state["armed"]
                and zone.superblock_offset
                <= offset
                < zone.superblock_offset + zone.superblock_size
            ):
                if state["left"] == 0:
                    raise ChaosCrash(0)
                state["left"] -= 1
            orig_write(offset, data)

        storage.write = guarded_write
        orig_cp = r.superblock.checkpoint

        def armed_checkpoint():
            state["armed"] = True
            try:
                orig_cp()
            finally:
                state["armed"] = False

        r.superblock.checkpoint = armed_checkpoint

        c = setup_client(cl)
        do_request(cl, c, Operation.CREATE_ACCOUNTS, account_batch([1, 2]))
        crashed = False
        chain_before = {}
        commit_before = 0
        i = 0
        while not crashed and i < 2 * self.INTERVAL:
            c.request(Operation.CREATE_TRANSFERS, transfer_batch([
                dict(id=1 + i, debit_account_id=1, credit_account_id=2,
                     amount=1, ledger=1, code=1)
            ]))
            try:
                cl.run_until(lambda: c.idle, 20_000)
            except ChaosCrash:
                chain_before = dict(cl.replicas[0].commit_checksums)
                commit_before = cl.replicas[0].commit_min
                cl.crash_replica(0, torn_write_probability=1.0)
                crashed = True
            i += 1
        assert crashed, "checkpoint boundary never reached"
        state["armed"] = False
        return cl, chain_before, commit_before

    @pytest.mark.parametrize("crash_after_writes", [0, 1, 2, 3])
    def test_crash_at_each_superblock_sector_boundary(
        self, crash_after_writes
    ):
        cl, chain_before, commit_before = self._drive_to_crash(
            crash_after_writes
        )
        assert commit_before % self.INTERVAL == 0
        cl.restart_replica(0)
        r = cl.replicas[0]
        cp = r.superblock.state.op_checkpoint
        if crash_after_writes < 2:
            assert cp == 0, f"torn checkpoint won with {crash_after_writes} writes"
        else:
            assert cp == commit_before
        assert r.commit_min == commit_before
        for op in range(r.checksum_floor + 1, commit_before + 1):
            assert r.commit_checksums[op] == chain_before[op], (
                f"hash chain diverged at op {op} after torn-checkpoint crash"
            )
        assert r.recovery_stats["wal_replay_ops"] == commit_before - cp


# --- recovery lifecycle stamps -------------------------------------------


class TestRecoveryLifecycle:
    def _catch_up(self, cl, victim, timeout=60_000):
        target = max(
            r.commit_min for r in cl.replicas if r is not None
        )
        cl.run_until(
            lambda: cl.replicas[victim] is not None
            and not cl.replicas[victim]._recovery_active
            and cl.replicas[victim].commit_min >= target,
            timeout,
        )

    def test_recovery_stats_after_dirty_restart(self):
        cl = cpu_cluster(replica_count=3, seed=11)
        c = setup_client(cl)
        do_request(cl, c, Operation.CREATE_ACCOUNTS, account_batch([1, 2]))
        for i in range(6):
            do_request(cl, c, Operation.CREATE_TRANSFERS, transfer_batch([
                dict(id=1 + i, debit_account_id=1, credit_account_id=2,
                     amount=1, ledger=1, code=1)
            ]))
        cl.crash_replica(2, torn_write_probability=0.0)
        do_request(cl, c, Operation.CREATE_TRANSFERS, transfer_batch([
            dict(id=100, debit_account_id=1, credit_account_id=2,
                 amount=1, ledger=1, code=1)
        ]))
        cl.restart_replica(2)
        r = cl.replicas[2]
        assert r.recovery_stats["wal_replay_ops"] >= 0
        assert r.recovery_stats["wal_replay_s"] > 0
        assert r._recovery_active
        self._catch_up(cl, 2)
        assert cl.replicas[2].recovery_stats["time_to_rejoin_s"] > 0

    def test_single_replica_boot_replays_wal(self):
        cl = cpu_cluster(replica_count=1, seed=12)
        c = setup_client(cl)
        do_request(cl, c, Operation.CREATE_ACCOUNTS, account_batch([1, 2]))
        for i in range(5):
            do_request(cl, c, Operation.CREATE_TRANSFERS, transfer_batch([
                dict(id=1 + i, debit_account_id=1, credit_account_id=2,
                     amount=1, ledger=1, code=1)
            ]))
        tip = cl.replicas[0].commit_min
        cl.crash_replica(0, torn_write_probability=0.0)
        cl.restart_replica(0)
        r = cl.replicas[0]
        assert r.commit_min == tip
        assert r.recovery_stats["wal_replay_ops"] == tip
        assert r.recovery_stats["replay_ops_per_s"] > 0

    def test_recovery_state_gauge_and_journal_stamps(self):
        from tigerbeetle_tpu_torch import tracer
        from tigerbeetle_tpu_torch.vsr import replica as replica_mod

        tracer.enable()
        tracer.reset()
        try:
            cl = cpu_cluster(replica_count=3, seed=13)
            c = setup_client(cl)
            do_request(cl, c, Operation.CREATE_ACCOUNTS, account_batch([1]))
            cl.crash_replica(1, torn_write_probability=0.0)
            cl.restart_replica(1)
            self._catch_up(cl, 1)
            cl.run(50)
            g = tracer.gauges()
            assert g["vsr.recovery_state"] == replica_mod.RECOVERY_STATE_NORMAL
            assert g["vsr.recovery.journal_slots_recovered"] > 0
            assert "vsr.recovery.wal_replay_s" in g
            snap = tracer.snapshot()
            assert snap["recovery.boot"]["count"] >= 4  # 3 boots + restart
            assert snap["recovery.caught_up"]["count"] >= 1
        finally:
            tracer.disable()

    def test_recovery_stall_trips_flight_recorder(self):
        from tigerbeetle_tpu_torch import tracer

        tracer.enable()
        tracer.reset()
        try:
            cl = cpu_cluster(replica_count=3, seed=17)
            c = setup_client(cl)
            do_request(cl, c, Operation.CREATE_ACCOUNTS, account_batch([1]))
            cl.crash_replica(1, torn_write_probability=0.0)
            cl.restart_replica(1)
            r = cl.replicas[1]
            # Isolated, the restarted replica never learns the view:
            # the stall detector must trip a flight dump (tick-counted).
            cl.net.partition(("replica", 1), ("replica", 0))
            cl.net.partition(("replica", 1), ("replica", 2))
            r.RECOVERY_STALL_TICKS = 60
            cl.run(200)
            snap = tracer.snapshot()
            assert snap.get("mark.recovery_stall", {}).get("count", 0) >= 1
            assert tracer.flight_dumps(), "stall tripped but no flight dump"
        finally:
            tracer.disable()


# --- the chaos scenarios, in process on the CPU --------------------------


def _check_epilogue(res):
    det = res.to_dict()["determinism"]
    assert det["state_ops"] > 0
    assert det["storage_checkpoint"] > 0
    assert det["ops_checked"] > 0


def _check(res, name):
    d = res.to_dict()
    assert res.name.startswith(name)
    for key in (
        "recovery_time_s", "degraded_throughput_pct", "replay_ops_per_s",
    ):
        assert key in d
    assert d["recovery_time_s"] > 0
    assert 0 <= d["degraded_throughput_pct"] <= 100
    _check_epilogue(res)


class TestChaosScenarios:
    def test_harness_runs_on_the_requested_device(self):
        h = ChaosHarness(seed=0xDEAD1, device="cpu")
        assert all(
            str(r.state_machine.device) == "cpu"
            for r in h.cluster.replicas
        )

    def test_kill_restart(self):
        res = chaos.scenario_kill_restart(base_s=0.4, down_s=0.3, device="cpu")
        _check(res, "kill_restart")
        assert res.extra["wal_replay_s"] >= 0

    def test_state_sync(self):
        res = chaos.scenario_state_sync(base_s=0.4, device="cpu")
        _check(res, "state_sync")
        assert res.extra["lag_ops"] > 0
        assert res.extra["synced_to_checkpoint"] > 0

    def test_grid_storm(self):
        res = chaos.scenario_grid_storm(base_s=0.4, device="cpu")
        _check(res, "grid_storm")
        assert res.extra["corrupted_blocks"] > 0
        assert res.extra["repairs"] >= 1

    def test_torn_checkpoint(self):
        res = chaos.scenario_torn_checkpoint(base_s=0.4, device="cpu")
        _check(res, "torn_checkpoint")
        assert res.extra["checkpoint_at_boot"] == res.extra[
            "checkpoint_before_crash"
        ]

    def test_primary_kill(self):
        res = chaos.scenario_primary_kill(base_s=0.4, device="cpu")
        d = res.to_dict()
        assert d["view_change_time_s"] > 0
        assert 0 <= d["degraded_throughput_pct"] <= 100
        assert d["blackout_p99_ms"] >= 0
        assert d["elected_view"] >= 1
        assert d["vc_svc_wait_s"] >= 0 and d["vc_sv_replay_s"] >= 0
        _check_epilogue(res)

    def test_primary_flap(self):
        res = chaos.scenario_primary_flap(cycles=2, base_s=0.4, device="cpu")
        d = res.to_dict()
        assert d["elections"] == 2
        assert d["views_advanced"] >= 2
        _check_epilogue(res)

    def test_partition_primary(self):
        res = chaos.scenario_partition_primary(base_s=0.4, device="cpu")
        d = res.to_dict()
        assert d["view_change_time_s"] > 0
        assert d["isolated_suffix_ops"] >= 1
        assert d["rejoin_view"] >= 1
        _check_epilogue(res)

    def test_backup_of_view_skips_dead_replicas(self):
        h = ChaosHarness(seed=0xDEAD1, device="cpu")
        h.drive_until(lambda: h.tip() >= 2, 60.0)
        primary = h.primary_of_view()
        first_backup = (primary + 1) % h.cluster.replica_count
        assert h.backup_of_view() == first_backup
        h.cluster.crash_replica(first_backup, torn_write_probability=0.0)
        victim = h.backup_of_view()
        assert victim != primary
        assert victim != first_backup
        assert h.cluster.replicas[victim] is not None

    def test_run_all_lenient_fails_closed_on_process_error(self, monkeypatch):
        """A broken real-process kill/restart must not let the in-process
        twin's metrics stand in for it: lenient mode records the error
        and keeps the twin under `.sim` only; strict mode re-raises."""
        seen = []

        def fake(device=None):
            seen.append(device)
            return chaos.ScenarioResult("kill_restart", 0.1, 1.0, 5.0)

        monkeypatch.setattr(chaos, "SCENARIOS", {"kill_restart": fake})

        def boom(**kw):
            raise OSError("replica binary failed to boot")

        monkeypatch.setattr(chaos, "scenario_kill_restart_process", boom)
        out = chaos.run_all(lenient=True, device="cpu")
        kr = out["kill_restart"]
        assert "process_error" in kr
        assert "recovery_time_s" not in kr
        assert kr["sim"]["recovery_time_s"] == 0.1
        assert seen == ["cpu"]
        with pytest.raises(OSError):
            chaos.run_all(lenient=False, device="cpu")


# --- real `cli start --device=cpu` processes ------------------------------


class TestProcessScenarios:
    @pytest.mark.parametrize("server_args", [(), ("--commit-depth=8",)])
    def test_kill_restart_real_process(self, server_args):
        """SIGKILL a replica process mid-load, restart it on the same
        data file: acked transfers durable, WAL replay gauges scraped
        from the rebooted replica's /metrics. With --commit-depth=8 the
        commit stage's cross-batch window is as wide as it goes."""
        res = chaos.scenario_kill_restart_process(
            batches_before=12, batches_after=8, device="cpu",
            server_args=server_args,
        )
        d = res.to_dict()
        assert d["recovery_time_s"] > 0
        assert res.extra["wal_replay_ops"] > 0
        assert res.extra["acked_tx_before_kill"] > 0
        # Scraped from /metrics; on the CPU no kernel launches.
        for key in ("launches_before_kill", "launches_replay",
                    "launches_after_restart"):
            assert d[key] == {}

    def test_primary_kill_real_process(self):
        """Three `cli start --device=cpu` processes over TCP, open-loop
        sessions, the primary SIGKILLed: clients fail over on their own,
        acked-before-kill transfers are durable on the new primary, and
        the failover timeline comes off /metrics."""
        res = chaos.scenario_primary_kill_process(duration_s=10.0, device="cpu")
        d = res.to_dict()
        assert d["sessions_failed"] == 0
        assert d["failover_count"] > 0
        assert d["view_change_time_s"] > 0
        assert d["acked_checked"] > 0
        assert d["blackout_p99_ms"] > 0
        assert d["recovery_time_s"] > d["view_change_time_s"]
        assert d["launches_before_kill"] == {0: {}, 1: {}, 2: {}}
        assert d["launches_after"] == {0: {}, 1: {}, 2: {}}


def test_spawn_replica_starts_cli_on_the_device(tmp_path, monkeypatch):
    """`_spawn_replica` starts `cli start` on the asked device with the
    parent's environment, its `extra_args` before the data file, and
    keeps the child's stderr in `log_path` when one is given."""
    import subprocess

    got = {}

    class FakePopen:
        def __init__(self, argv, stdout, stderr, **kw):
            got["argv"], got["stderr"], got["kw"] = argv, stderr, kw
            self.stdout = open(os.devnull, "rb")

    monkeypatch.setattr(subprocess, "Popen", FakePopen)
    path = str(tmp_path / "x")
    chaos._spawn_replica(
        path, 1, 2, "test_min", "cpu", extra_args=("--commit-depth=8",),
        log_path=str(tmp_path / "r.log"),
    )
    argv = got["argv"]
    assert argv[1:4] == ["-m", "tigerbeetle_tpu_torch.cli", "start"]
    for flag in ("--device=cpu", "--config=test_min", "--metrics-port=2",
                 "--addresses=127.0.0.1:1", "--replica=0"):
        assert flag in argv
    assert argv[-2:] == ["--commit-depth=8", path]
    assert got["kw"] == {}
    assert got["stderr"].name == str(tmp_path / "r.log")
    chaos._spawn_replica(path, 1, 2, "test_min", "cuda")
    assert "--device=cuda" in got["argv"]
    assert got["stderr"] is subprocess.DEVNULL
