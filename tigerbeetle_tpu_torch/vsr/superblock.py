"""SuperBlock: the root of durability.

Mirrors upstream src/vsr/superblock.zig:55 — four sector-sized copies
holding the VSR state (view, log_view, checkpoint op, timestamps) plus a
checksum and a monotonically increasing sequence. Writes go out in two
sync'd waves (copies 0-1, then 2-3) so a crash mid-checkpoint always leaves
a valid quorum of either the old or the new sequence; open() picks the
highest-sequence valid copy (superblock_quorums.zig simplified: torn copies
are detected by checksum and skipped).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from tigerbeetle_tpu_torch.constants import SECTOR_SIZE
from tigerbeetle_tpu_torch.io.storage import Zone
from tigerbeetle_tpu_torch.vsr.header import checksum

MAGIC = 0x7B5B_00BE_E71E
COPIES = 4

SUPERBLOCK_DTYPE = np.dtype(
    [
        ("checksum_lo", "<u8"), ("checksum_hi", "<u8"),
        ("magic", "<u8"),
        ("copy", "<u4"),
        ("version", "<u4"),
        ("cluster_lo", "<u8"), ("cluster_hi", "<u8"),
        ("replica", "<u4"),
        ("replica_count", "<u4"),
        ("sequence", "<u8"),
        ("view", "<u4"),
        ("log_view", "<u4"),
        ("op_checkpoint", "<u8"),
        ("commit_min", "<u8"),
        ("commit_max", "<u8"),
        ("prepare_timestamp", "<u8"),
        ("commit_timestamp", "<u8"),
        ("parent_lo", "<u8"), ("parent_hi", "<u8"),  # checkpoint id chain
        # Grid block index of the checkpoint trailer's index block
        # (reference checkpoint_trailer.zig: checkpoint state lives in grid
        # blocks referenced from the superblock — ONE data file, no side
        # files). NO_TRAILER when op_checkpoint == 0.
        ("trailer_block", "<u4"),
        # Nonzero while block-level state sync is incomplete: the trailer's
        # RAM state is installed but some referenced grid blocks are still
        # missing — the replica must finish fetching them before serving
        # (reference sync.zig SyncStage persistence).
        ("sync_pending", "<u4"),
        # The op of the RECONFIGURE that promoted this replica out of
        # standby (0 = never promoted): replaying that op must not make
        # the promoted replica retire itself from its own slot.
        ("promoted_at_op", "<u8"),
        # Configuration epoch: count of committed RECONFIGURE ops. Carried
        # in quorum-vote message headers to fence a stale slot occupant out
        # of prepare/view-change quorums after its slot was reassigned
        # (reference epoch semantics, vsr.zig Membership; advisor r4).
        ("config_epoch", "<u8"),
        ("reserved", "V360"),
    ]
)
assert SUPERBLOCK_DTYPE.itemsize == 512

NO_TRAILER = 0xFFFFFFFF


@dataclass
class VSRState:
    """The durable consensus state (superblock.zig VSRState)."""

    cluster: int = 0
    replica: int = 0
    replica_count: int = 1
    view: int = 0
    log_view: int = 0
    op_checkpoint: int = 0
    commit_min: int = 0
    commit_max: int = 0
    prepare_timestamp: int = 0
    commit_timestamp: int = 0
    parent: int = 0
    trailer_block: int = 0xFFFFFFFF  # NO_TRAILER
    sync_pending: int = 0
    promoted_at_op: int = 0
    config_epoch: int = 0
    sequence: int = field(default=0)


class SuperBlock:
    def __init__(self, storage, zone: Zone) -> None:
        self.storage = storage
        self.zone = zone
        self.state = VSRState()

    def _encode(self, copy: int) -> bytes:
        rec = np.zeros((), dtype=SUPERBLOCK_DTYPE)
        s = self.state
        rec["magic"] = MAGIC
        rec["copy"] = copy
        rec["version"] = 1
        rec["cluster_lo"] = s.cluster & ((1 << 64) - 1)
        rec["cluster_hi"] = s.cluster >> 64
        rec["replica"] = s.replica
        rec["replica_count"] = s.replica_count
        rec["sequence"] = s.sequence
        rec["view"] = s.view
        rec["log_view"] = s.log_view
        rec["op_checkpoint"] = s.op_checkpoint
        rec["commit_min"] = s.commit_min
        rec["commit_max"] = s.commit_max
        rec["prepare_timestamp"] = s.prepare_timestamp
        rec["commit_timestamp"] = s.commit_timestamp
        rec["parent_lo"] = s.parent & ((1 << 64) - 1)
        rec["parent_hi"] = s.parent >> 64
        rec["trailer_block"] = s.trailer_block
        rec["sync_pending"] = s.sync_pending
        rec["promoted_at_op"] = s.promoted_at_op
        rec["config_epoch"] = s.config_epoch
        c = checksum(rec.tobytes()[16:])
        rec["checksum_lo"] = c & ((1 << 64) - 1)
        rec["checksum_hi"] = c >> 64
        raw = rec.tobytes()
        return raw + b"\x00" * (SECTOR_SIZE - len(raw))

    @staticmethod
    def _decode(raw: bytes) -> VSRState | None:
        rec = np.frombuffer(raw[: SUPERBLOCK_DTYPE.itemsize], dtype=SUPERBLOCK_DTYPE)[0]
        if int(rec["magic"]) != MAGIC:
            return None
        want = int(rec["checksum_lo"]) | (int(rec["checksum_hi"]) << 64)
        if want != checksum(raw[16 : SUPERBLOCK_DTYPE.itemsize]):
            return None
        return VSRState(
            cluster=int(rec["cluster_lo"]) | (int(rec["cluster_hi"]) << 64),
            replica=int(rec["replica"]),
            replica_count=int(rec["replica_count"]),
            view=int(rec["view"]),
            log_view=int(rec["log_view"]),
            op_checkpoint=int(rec["op_checkpoint"]),
            commit_min=int(rec["commit_min"]),
            commit_max=int(rec["commit_max"]),
            prepare_timestamp=int(rec["prepare_timestamp"]),
            commit_timestamp=int(rec["commit_timestamp"]),
            parent=int(rec["parent_lo"]) | (int(rec["parent_hi"]) << 64),
            trailer_block=int(rec["trailer_block"]),
            sync_pending=int(rec["sync_pending"]),
            promoted_at_op=int(rec["promoted_at_op"]),
            config_epoch=int(rec["config_epoch"]),
            sequence=int(rec["sequence"]),
        )

    def _copy_offset(self, copy: int) -> int:
        return self.zone.superblock_offset + copy * SECTOR_SIZE

    def checkpoint(self) -> None:
        """Durably advance the superblock (two sync'd waves of copies)."""
        self.state.sequence += 1
        for wave in ((0, 1), (2, 3)):
            for copy in wave:
                self.storage.write(self._copy_offset(copy), self._encode(copy))
            self.storage.sync()

    def format(self, state: VSRState) -> None:
        self.state = state
        self.state.sequence = 1
        for copy in range(COPIES):
            self.storage.write(self._copy_offset(copy), self._encode(copy))
        self.storage.sync()

    # A state is trusted only when this many copies carry the identical
    # content (superblock_quorums.zig quorum threshold for 4 copies): a
    # crashed checkpoint attempt can leave at most one torn singleton copy
    # of its sequence, so demanding two identical copies excludes every
    # frankenstein mix of same-sequence attempts while the two-wave write
    # order guarantees the previous sequence still holds a quorum.
    QUORUM = 2

    def open(self) -> VSRState:
        """Pick the highest-sequence state backed by a checksum quorum."""
        groups: dict[bytes, tuple[VSRState, int]] = {}
        for copy in range(COPIES):
            raw = self.storage.read(self._copy_offset(copy), SECTOR_SIZE)
            st = self._decode(raw)
            if st is None:
                continue
            # Identity = content without the copy index (bytes 16.. minus
            # the copy field — compare the decoded state itself).
            key = repr(st).encode()
            prev = groups.get(key)
            groups[key] = (st, (prev[1] if prev else 0) + 1)
        best: VSRState | None = None
        for st, count in groups.values():
            if count < self.QUORUM:
                continue
            if best is None or st.sequence > best.sequence:
                best = st
        if best is None:
            raise RuntimeError(
                "no superblock quorum — data file corrupt, unformatted, or "
                "written by a host with the other checksum algorithm "
                "(aegis128l against blake2b)"
            )
        self.state = best
        # Repair on open (superblock.zig): restore full redundancy before
        # serving — otherwise one later latent sector error could roll the
        # replica back past a state it already acked against. Only copies
        # that DIFFER from the winner are rewritten: the existing quorum
        # copies are never touched, so a crash mid-repair (tearing the
        # in-flight rewrites) cannot reduce the surviving quorum.
        repaired = False
        for copy in range(COPIES):
            want = self._encode(copy)
            raw = self.storage.read(self._copy_offset(copy), SECTOR_SIZE)
            if raw != want:
                self.storage.write(self._copy_offset(copy), want)
                repaired = True
        if repaired:
            self.storage.sync()
        return best
