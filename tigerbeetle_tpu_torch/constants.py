"""Cluster and process constants.

Mirrors the reference's config presets and derived constants
(upstream src/config.zig:58-303, src/constants.zig). Values that define
wire/disk compatibility (message size, batch size, record size) match the
reference exactly; purely internal tuning values are this build's choices.
"""

from __future__ import annotations

import dataclasses

# Wire format (reference message_header.zig:70, config.zig:78).
MESSAGE_SIZE_MAX = 1 << 20  # 1 MiB
HEADER_SIZE = 256
MESSAGE_BODY_SIZE_MAX = MESSAGE_SIZE_MAX - HEADER_SIZE

# 8190 = (1 MiB - 256 B) / 128 B (reference state_machine.zig:70-75).
BATCH_MAX = MESSAGE_BODY_SIZE_MAX // 128
assert BATCH_MAX == 8190

SECTOR_SIZE = 4096
BLOCK_SIZE = 1 << 20  # grid block size (reference config.zig:114)

REPLICAS_MAX = 6
STANDBYS_MAX = 6
CLIENTS_MAX = 32
PIPELINE_PREPARE_QUEUE_MAX = 8  # reference config.zig:133
CLIENT_REQUEST_QUEUE_MAX = 32  # reference config.zig:87

JOURNAL_SLOT_COUNT = 1024  # reference config.zig:136
LSM_BATCH_MULTIPLE = 4  # reference: lsm_batch_multiple (compaction bar pacing)
LSM_LEVELS = 7  # reference config.zig:140
LSM_GROWTH_FACTOR = 8

# Checkpoint every this many ops (reference constants.zig:47-73):
# journal_slot_count - lsm_batch_multiple
#   - lsm_batch_multiple * ceil(pipeline_prepare_queue_max / lsm_batch_multiple),
# and the result must stay a multiple of lsm_batch_multiple (compaction bars).
VSR_CHECKPOINT_INTERVAL = (
    JOURNAL_SLOT_COUNT
    - LSM_BATCH_MULTIPLE
    - LSM_BATCH_MULTIPLE * (-(-PIPELINE_PREPARE_QUEUE_MAX // LSM_BATCH_MULTIPLE))
)
assert VSR_CHECKPOINT_INTERVAL % LSM_BATCH_MULTIPLE == 0

NS_PER_S = 1_000_000_000


@dataclasses.dataclass(frozen=True)
class Config:
    """Runtime-selected configuration preset.

    `accounts_max` / `transfers_max` size the device-resident state tables
    (this build's analog of the reference's cache + LSM sizing flags,
    reference src/tigerbeetle/cli.zig cache-* flags).
    """

    name: str = "production"
    accounts_max: int = 1 << 20
    transfers_max: int = 1 << 24
    batch_max: int = BATCH_MAX
    journal_slot_count: int = JOURNAL_SLOT_COUNT
    pipeline_max: int = PIPELINE_PREPARE_QUEUE_MAX
    clients_max: int = CLIENTS_MAX
    checkpoint_interval: int = VSR_CHECKPOINT_INTERVAL
    # Device memtable runs before a merge is forced (LSM-on-device shape).
    state_runs_max: int = 4
    # Wire/disk: max message = header + batch_max records (reference
    # message_header.zig:70; smaller in test presets so WAL files stay tiny).
    message_size_max: int = MESSAGE_SIZE_MAX
    # LSM grid geometry (reference config.zig block_size + grid sizing
    # flags): lsm_block_size × grid_block_count bounds the durable LSM
    # tier; files are sparse so production reserves address space cheaply.
    lsm_block_size: int = 1 << 18  # 256 KiB
    grid_block_count: int = 1 << 15  # × 256 KiB = 8 GiB
    # Grid block LRU cache (reference cache_grid flag, 1 GiB default):
    # point lookups over a compacted store are RAM-resident when the hot
    # set fits here.
    grid_cache_blocks: int = 1 << 12  # × 256 KiB = 1 GiB
    # Transfer-id / account-index memtable rows before a level-0 flush.
    index_memtable_rows: int = 1 << 17
    # Compaction beat pacing: merged entries per compact_step call (small
    # values make jobs span many beats and checkpoints). The literal must
    # equal lsm.tree.DEFAULT_COMPACT_QUOTA, which asserts it.
    compact_quota_entries: int = 1 << 15
    # Admission control (docs/FRONT_DOOR.md): a REQUEST arriving on the
    # primary when request_queue already holds this many waiting requests
    # is shed with a retryable BUSY reply instead of queued — offered
    # load beyond saturation degrades accepted throughput gracefully
    # instead of growing queue-wait without bound. Sized for the 10k-
    # session front door: deep enough that a synchronized burst from a
    # large session population rides through, shallow enough that queue
    # wait stays bounded by ~queue_depth x batch service time.
    request_queue_max: int = 4096
    # Optional latency-based shed (0 = disabled): when the tracer's
    # running perceived p99 (arrive→reply, server-side) exceeds this many
    # milliseconds, the door sheds as if the queue were full. Checked at
    # tick granularity, never per-request.
    admission_p99_ms: float = 0.0


PRODUCTION = Config()
DEVELOPMENT = Config(
    name="development",
    accounts_max=1 << 18,
    transfers_max=1 << 20,
    lsm_block_size=1 << 16,
    grid_block_count=1 << 13,  # 512 MiB
    grid_cache_blocks=1 << 11,  # 128 MiB
    index_memtable_rows=1 << 14,
)
TEST_MIN = Config(
    name="test_min",
    accounts_max=1 << 10,
    transfers_max=1 << 12,
    batch_max=64,
    journal_slot_count=32,
    pipeline_max=4,
    clients_max=4,
    checkpoint_interval=16,
    state_runs_max=2,
    message_size_max=HEADER_SIZE + 64 * 128,
    lsm_block_size=1 << 12,  # 4 KiB
    grid_block_count=1 << 12,  # 16 MiB
    grid_cache_blocks=64,
    index_memtable_rows=512,
)


def config_by_name(name: str) -> Config:
    return {"production": PRODUCTION, "development": DEVELOPMENT, "test_min": TEST_MIN}[name]
