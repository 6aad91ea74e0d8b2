"""The port's in-process pipeline profiler (tigerbeetle_tpu_torch/
profile_e2e.py) on the CPU at a small size: TEST_MIN (256 accounts, a
few batches of 64 transfers).

Each stage layout (the default overlapped stages, --serial-commit,
--serial-store, both, and a depth-2 commit window) runs the reference
profiler's checks inside `run` (every batch replied, no shed,
server.total within 5% of the wall clock, disjoint rows within
server.total on the serial commit, no kernel built inside the window, no
request shed) and dumps a trace that tools/trace_summary.py reads; its
account balances equal the JAX package's Replica(sm_backend="numpy") fed
the same sealed requests one at a time. With the replica on frozen time,
the final commit checksums equal the reference's too."""

import os
import subprocess
import sys

import pytest
import torch

from tigerbeetle_tpu_torch import profile_e2e

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(device="cpu", config="test_min")
ACCOUNTS, BATCH = profile_e2e.stream_shape("test_min")


BATCHES = 6  # measured; the 8 warm-up batches exceed TEST_MIN's pipeline_max of 4


def _quiet(line):
    pass


@pytest.mark.parametrize("stages", [
    {},
    {"overlap": False},
    {"store_async": False},
    {"overlap": False, "store_async": False},
    {"commit_depth": 2},
], ids=["default", "serial-commit", "serial-store", "serial-both", "depth-2"])
def test_profile_runs_and_checks_on_cpu(tmp_path, stages, reference):
    trace = str(tmp_path / "e2e.json")
    rec = profile_e2e.run(batches=BATCHES, trace_path=trace, out=_quiet,
                          **SMALL, **stages)
    assert rec["extra"]["batches"] == BATCHES and rec["kernel_builds"] == 0
    assert rec["balances_digest"] == reference[1]
    assert rec["value"] > 0 and rec["tx_per_s"] > 0
    assert rec["metric"] == "e2e_stage_profile_ms_per_batch"
    for row in ("parse", "wal", "execute", "reply", "other", "query.total"):
        assert row in rec["extra"]["stages"]
    assert rec["extra"]["overlap"] == stages.get("overlap", True)
    assert "lifecycle_perceived_ms" in rec["extra"]["lifecycle"]
    assert rec["trace"] == trace and os.path.exists(trace)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "trace_summary.py"), trace],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "server.total" in out.stdout


def test_stage_tables_are_printed():
    lines = []
    profile_e2e.run(batches=4, out=lines.append, **SMALL)
    text = "\n".join(lines)
    for head in ("stage attribution", "worker threads", "stage idle/stall",
                 "per-op lifecycle decomposition", "query engine"):
        assert head in text


def test_main_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        profile_e2e.main(["--batches", "1"])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    msgs = profile_e2e.sealed_requests(ACCOUNTS, BATCH, BATCHES + 8)
    return _reference_run(msgs, tmp_path_factory.mktemp("ref"))


def _reference_run(msgs, tmp_path):
    """The JAX package's replica (numpy state machine, frozen time) fed the
    same sealed requests one at a time: (commit checksums, balances)."""
    from tigerbeetle_tpu.constants import config_by_name
    from tigerbeetle_tpu.io.storage import FileStorage, Zone
    from tigerbeetle_tpu.vsr.clock import DeterministicTime
    from tigerbeetle_tpu.vsr.header import Message
    from tigerbeetle_tpu.vsr.replica import Replica

    cfg = config_by_name("test_min")
    zone = Zone.for_config(cfg.journal_slot_count, cfg.message_size_max,
                           grid_block_count=cfg.grid_block_count,
                           grid_block_size=cfg.lsm_block_size)
    path = str(tmp_path / "ref.tigerbeetle")
    storage = FileStorage(path, size=zone.total_size, create=True)
    Replica.format(storage, zone, 0, 0, 1)
    storage.close()
    storage = FileStorage(path)
    bus = profile_e2e.DummyBus()
    replica = Replica(cluster=0, replica_index=0, replica_count=1,
                      storage=storage, zone=zone, config=cfg, bus=bus,
                      sm_backend="numpy", time=DeterministicTime(tick_ns=0))
    replica.open()
    try:
        for k, m in enumerate(msgs, start=1):
            replica.on_message(Message.from_bytes(m.to_bytes()))
            assert len(bus.replies) == k
        sm = replica.state_machine
        return dict(replica.commit_checksums), profile_e2e.balances_digest(
            sm, ACCOUNTS)
    finally:
        storage.close()


def test_commit_checksums_and_balances_equal_the_reference(reference):
    rec = profile_e2e.run(batches=BATCHES, frozen_time=True, out=_quiet,
                          **SMALL)
    ref_sums, ref_balances = reference
    assert rec["commit_checksums"] == ref_sums
    assert rec["commit_checksum"] == ref_sums[max(ref_sums)]
    assert rec["balances_digest"] == ref_balances
    # register, the account batches and every transfer batch committed
    assert (ACCOUNTS, BATCH) == (256, 64)
    assert max(ref_sums) == 1 + ACCOUNTS // BATCH + BATCHES + 8


def test_sealed_requests_are_the_reference_stream():
    msgs = profile_e2e.sealed_requests(128, 64, 3)
    # register, two account batches of 64, three transfer batches
    assert len(msgs) == 1 + 2 + 3
    assert [m.header["request"] for m in msgs] == list(range(1, 7))
    for m in msgs:
        assert m.header.valid_checksum_body(m.body)
