"""Superblock torn-write fuzzer on the port, held against the reference.

Random sequences of checkpoint advances interleaved with dirty crashes
(unsynced copy writes lost or torn at sector boundaries), a crash
between the two sync'd waves of a checkpoint, and single-copy sector
corruption, over the port's SuperBlock on two storages: the in-memory
MemStorage and the FileStorage with fault injection on. Invariants after
every reopen:

  1. open() always succeeds (the two-wave write discipline guarantees a
     valid quorum of old or new copies survives any single crash).
  2. The recovered sequence is monotonic: >= the last checkpoint whose
     second wave completed (durable floor) and <= the last attempted.
  3. Recovered state content matches what was checkpointed at that
     sequence (no mixes across sequences).

The same seed drives the reference package's SuperBlock on the same
storage kind, and the recovered (sequence, commit_min) after every step
must be the reference's.
"""

import random

import pytest

from tigerbeetle_tpu.constants import SECTOR_SIZE as REF_SECTOR_SIZE
from tigerbeetle_tpu.io import storage as ref_storage
from tigerbeetle_tpu.vsr import superblock as ref_superblock
from tigerbeetle_tpu_torch.constants import SECTOR_SIZE
from tigerbeetle_tpu_torch.io import storage as port_storage
from tigerbeetle_tpu_torch.vsr import superblock as port_superblock


class _SimulatedCrash(Exception):
    pass


def _crashy(base):
    """`base` (a MemStorage or FileStorage class) whose sync() may raise
    after persisting, aborting the caller at a chosen wave."""

    class Crashy(base):
        fail_after_syncs = None
        syncs = 0

        def sync(self) -> None:
            super().sync()
            self.syncs += 1
            if (
                self.fail_after_syncs is not None
                and self.syncs >= self.fail_after_syncs
            ):
                self.fail_after_syncs = None
                raise _SimulatedCrash()

    return Crashy


def _fuzz(seed, storage_mod, sb_mod, sector_size, kind, path):
    """One seeded run; returns the recovered (sequence, commit_min)
    after every step."""
    zone = storage_mod.Zone.for_config(journal_slot_count=8, message_size_max=4096)
    if kind == "mem":
        storage = _crashy(storage_mod.MemStorage)(zone.total_size, seed)
        faulty = storage._faulty_sectors
    else:
        storage = _crashy(storage_mod.FileStorage)(
            path, size=zone.total_size, create=True, fault_injection=True,
        )
        faulty = storage._fi_faulty
    rng = random.Random(seed)
    sb = sb_mod.SuperBlock(storage, zone)
    sb.format(sb_mod.VSRState(cluster=7, replica=0, replica_count=3))

    # sequence -> the commit_min values ever attempted at it (after a
    # mid-checkpoint crash rolls back, the next checkpoint legitimately
    # reuses the sequence number with new content).
    written = {1: {0}}
    durable_floor = 1  # both waves of this sequence are on disk
    highest_attempt = 1
    next_commit = 10
    trace = []
    try:
        for step in range(rng.randint(4, 14)):
            action = rng.random()
            if action < 0.55:
                seq = sb.state.sequence + 1
                sb.state.commit_min = next_commit
                sb.state.commit_max = next_commit
                written.setdefault(seq, set()).add(next_commit)
                next_commit += 10
                highest_attempt = max(highest_attempt, seq)
                if rng.random() < 0.4:
                    storage.syncs = 0
                    storage.fail_after_syncs = 1  # die after the first wave
                try:
                    sb.checkpoint()
                    durable_floor = max(durable_floor, seq)
                except _SimulatedCrash:
                    # First wave synced: copies 0-1 carry the new sequence.
                    # The crash also tears any remaining unsynced writes.
                    storage.crash(torn_write_probability=rng.random())
            elif action < 0.8:
                storage.crash(torn_write_probability=rng.random())
            else:
                # Latent sector fault on ONE copy (quorum still holds).
                copy = rng.randrange(sb_mod.COPIES)
                storage.corrupt_sector(
                    (zone.superblock_offset + copy * sector_size) // sector_size
                )
            # Reopen from disk as a fresh process would.
            sb2 = sb_mod.SuperBlock(storage, zone)
            st = sb2.open()
            assert durable_floor <= st.sequence <= highest_attempt, (
                seed, step, durable_floor, st.sequence, highest_attempt
            )
            assert st.commit_min in written[st.sequence], (seed, step)
            assert st.cluster == 7 and st.replica_count == 3
            trace.append((st.sequence, st.commit_min))
            sb = sb2
            durable_floor = max(durable_floor, st.sequence)
            # Heal injected sector faults (a scrubber's rewrite).
            faulty.clear()
    finally:
        if kind == "file":
            storage.close()
    return trace


@pytest.mark.parametrize(
    "kind,seed",
    [("mem", s) for s in range(50)] + [("file", s) for s in range(25)],
)
def test_torn_checkpoint_crashes_match_reference(kind, seed, tmp_path):
    port = _fuzz(
        seed, port_storage, port_superblock, SECTOR_SIZE, kind,
        str(tmp_path / "port.sb"),
    )
    ref = _fuzz(
        seed, ref_storage, ref_superblock, REF_SECTOR_SIZE, kind,
        str(tmp_path / "ref.sb"),
    )
    assert port == ref
    assert port, "no step ran"
