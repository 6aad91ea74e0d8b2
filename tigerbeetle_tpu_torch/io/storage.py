"""Block storage: sector-addressed durable byte ranges.

The production backend is a file with TWO write disciplines, mirroring the
reference's O_DIRECT sector IO (src/storage.zig:14):

  - `write` + `sync`: buffered pwrite, fdatasync barrier (superblock,
    header ring, small metadata).
  - `write_durable`: sector-aligned O_DIRECT|O_DSYNC pwrite — durable at
    syscall return, bypassing the page cache entirely. This is the WAL
    prepare-body path: a whole-file fdatasync flushes EVERY dirty page
    (grid blocks included) and concurrent pwrites stall behind it, which
    measured 3-4x slower under sustained load than direct DMA.
  - `writeback_kick`: non-blocking sync_file_range(WRITE) so buffered grid
    writes stream to disk continuously instead of piling up for the next
    checkpoint's fdatasync.

The test backend is in-memory with per-sector fault injection, mirroring
src/testing/storage.zig:57 — reads of faulty sectors return corrupted
bytes so recovery paths are exercised, and `crash()` drops writes that
were not yet synced (torn-write model).

The on-disk layout zones mirror src/vsr.zig:67-109.
"""

from __future__ import annotations

import mmap
import os
import threading
from dataclasses import dataclass
from typing import Sequence

from tigerbeetle_tpu_torch.constants import SECTOR_SIZE
from tigerbeetle_tpu_torch.vsr.header import HEADER_SIZE

# sync_file_range(2) via libc (not in the os module). Async writeback
# start only — NOT a durability barrier (no disk-cache flush): used purely
# to smooth dirty-page accumulation between checkpoints.
_SYNC_FILE_RANGE_WRITE = 2
_libc = None
_libc_tried = False


def _sync_file_range(fd: int, offset: int, nbytes: int) -> None:
    global _libc, _libc_tried
    if not _libc_tried:
        _libc_tried = True
        try:
            import ctypes

            _libc = ctypes.CDLL(None, use_errno=True)
            _libc.sync_file_range.argtypes = [
                ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint,
            ]
        except (OSError, AttributeError):
            _libc = None
    if _libc is not None:
        try:
            _libc.sync_file_range(fd, offset, nbytes, _SYNC_FILE_RANGE_WRITE)
        except OSError:
            pass


@dataclass(frozen=True)
class Zone:
    """Fixed on-disk layout (offsets derived from a Config at format time)."""

    superblock_offset: int
    superblock_size: int
    wal_headers_offset: int
    wal_headers_size: int
    wal_prepares_offset: int
    wal_prepares_size: int
    client_replies_offset: int
    client_replies_size: int
    grid_offset: int = 0
    grid_size: int = 0
    grid_block_size: int = 0

    @property
    def grid_block_count(self) -> int:
        return self.grid_size // self.grid_block_size if self.grid_block_size else 0

    @property
    def total_size(self) -> int:
        return max(
            self.client_replies_offset + self.client_replies_size,
            self.grid_offset + self.grid_size,
        )

    @staticmethod
    def for_config(
        journal_slot_count: int,
        message_size_max: int,
        superblock_copies: int = 4,
        superblock_copy_size: int = SECTOR_SIZE,
        grid_block_count: int = 0,
        grid_block_size: int = 0,
    ) -> "Zone":
        # No client_replies zone (reference client_replies.zig:501 reserves
        # clients_max 1 MiB slots): in this build replies are durable
        # WITHOUT dedicated storage — the deterministic state machine
        # rebuilds every session's last reply during WAL replay, and
        # checkpoints persist the client table including sealed replies
        # (vsr/snapshot.py clients section). tests/test_cluster.py
        # test_reply_durable_across_crash proves the at-most-once resend
        # contract across a dirty restart.
        sb_size = superblock_copies * superblock_copy_size
        wh_size = journal_slot_count * HEADER_SIZE
        wh_size = -(-wh_size // SECTOR_SIZE) * SECTOR_SIZE
        wp_size = journal_slot_count * message_size_max
        sb_off = 0
        wh_off = sb_off + sb_size
        wp_off = wh_off + wh_size
        cr_off = wp_off + wp_size
        gr_off = -(-cr_off // SECTOR_SIZE) * SECTOR_SIZE
        return Zone(
            superblock_offset=sb_off, superblock_size=sb_size,
            wal_headers_offset=wh_off, wal_headers_size=wh_size,
            wal_prepares_offset=wp_off, wal_prepares_size=wp_size,
            client_replies_offset=cr_off, client_replies_size=0,
            grid_offset=gr_off, grid_size=grid_block_count * grid_block_size,
            grid_block_size=grid_block_size,
        )


class MemStorage:
    """In-memory storage with fault injection and a crash model.

    Thread-safe for the simulated pipeline stages: the async store
    (StoreExecutor) and commit-executor threads write/flush while the
    sim thread reads, syncs, or crashes — one lock keeps the _unsynced
    overlay and _data image consistent (FileStorage relies on pread/
    pwrite atomicity instead)."""

    def __init__(self, size: int, seed: int = 0) -> None:
        self.size = size
        self._data = bytearray(size)
        # Writes since the last sync: {offset: bytes} — dropped on crash()
        # with probability per write (torn-write model).
        self._unsynced: dict[int, bytes] = {}
        self._faulty_sectors: set[int] = set()
        self._lock = threading.Lock()
        import random

        self._rng = random.Random(seed)
        self.reads = 0
        self.writes = 0

    def read(self, offset: int, size: int) -> bytes:
        self.reads += 1
        with self._lock:
            return self._read_locked(offset, size)

    def _read_locked(self, offset: int, size: int) -> bytes:
        out = bytearray(self._data[offset : offset + size])
        # Overlay unsynced writes (the OS page cache view).
        for woff, wdata in self._unsynced.items():
            lo = max(offset, woff)
            hi = min(offset + size, woff + len(wdata))
            if lo < hi:
                out[lo - offset : hi - offset] = wdata[lo - woff : hi - woff]
        # Corrupt faulty sectors.
        first = offset // SECTOR_SIZE
        last = (offset + size - 1) // SECTOR_SIZE
        for s in range(first, last + 1):
            if s in self._faulty_sectors:
                lo = max(offset, s * SECTOR_SIZE)
                hi = min(offset + size, (s + 1) * SECTOR_SIZE)
                out[lo - offset : hi - offset] = bytes(
                    (b ^ 0xA5) for b in out[lo - offset : hi - offset]
                )
        return bytes(out)

    def write(self, offset: int, data: bytes) -> None:
        assert offset + len(data) <= self.size
        self.writes += 1
        with self._lock:
            self._unsynced[offset] = bytes(data)

    def write_batch(self, segments) -> None:
        """Buffered writes of [(offset, data), ...] (FileStorage routes
        these through one native pwritev call; here they are just the
        same buffered writes)."""
        for offset, data in segments:
            self.write(offset, data)

    def write_durable(self, offset: int, chunks: Sequence[bytes]) -> None:
        """Durable-at-return write (the O_DIRECT|O_DSYNC model): lands in
        the synced image immediately, never pending in the crash model."""
        data = b"".join(chunks)
        assert offset + len(data) <= self.size
        self.writes += 1
        with self._lock:
            self._data[offset : offset + len(data)] = data
            # An older buffered write at the same offset must not shadow
            # the durable bytes through the read overlay.
            self._unsynced.pop(offset, None)

    def writeback_kick(self, offset: int, nbytes: int) -> None:
        pass  # page-cache writeback pacing: meaningless in memory

    def sync(self) -> None:
        with self._lock:
            for woff, wdata in self._unsynced.items():
                self._data[woff : woff + len(wdata)] = wdata
            self._unsynced = {}

    # --- fault injection ------------------------------------------------

    def crash(self, torn_write_probability: float = 0.5) -> None:
        """Lose or tear unsynced writes, then clear them (process crash)."""
        with self._lock:
            self._crash_locked(torn_write_probability)

    def _crash_locked(self, torn_write_probability: float) -> None:
        for woff, wdata in self._unsynced.items():
            r = self._rng.random()
            if r < torn_write_probability:
                continue  # write lost entirely
            # write applied, possibly torn at a sector boundary
            keep = len(wdata)
            if self._rng.random() < 0.5 and len(wdata) > SECTOR_SIZE:
                sectors = len(wdata) // SECTOR_SIZE
                keep = self._rng.randrange(1, sectors + 1) * SECTOR_SIZE
            self._data[woff : woff + keep] = wdata[:keep]
        self._unsynced = {}

    def corrupt_sector(self, sector: int) -> None:
        self._faulty_sectors.add(sector)

    def repair_sector(self, sector: int) -> None:
        self._faulty_sectors.discard(sector)


class FileStorage:
    """File-backed storage: buffered writes + fdatasync, plus an O_DIRECT
    second fd for sector-aligned durable-at-return writes (the WAL body
    path — see module docstring).

    Fault injection (chaos parity with MemStorage, gated by the
    `fault_injection` ctor arg):
    `crash(torn_write_probability)` models a power-cut by REVERTING
    buffered writes since the last sync to their pre-images (lost
    entirely with the given probability, else possibly torn at a sector
    boundary — write_durable is never pending, exactly the MemStorage
    crash model); `corrupt_sector`/`repair_sector` XOR-corrupt reads of
    marked sectors. When the gate is off every fault path is a no-op and
    the hot read/write paths pay one boolean check."""

    DIRECT_ALIGN = 4096  # ≥ any real logical block size; = SECTOR_SIZE

    def __init__(
        self, path: str, size: int | None = None, create: bool = False,
        fault_injection: bool = False,
    ) -> None:
        self.path = path
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        self._fd = os.open(path, flags, 0o644)
        if create and size is not None:
            os.ftruncate(self._fd, size)
        self.size = os.fstat(self._fd).st_size
        # Fault injection (off in production: one `if` per read/write).
        self._fi = bool(fault_injection)
        # offset -> pre-image bytes of buffered writes since the last
        # sync (what crash() reverts to); the WAL-writer and store
        # threads write concurrently with the loop, hence the lock.
        self._fi_preimage: dict[int, bytes] = {}  # tidy: guarded-by=_fi_lock
        self._fi_faulty: set[int] = set()  # tidy: guarded-by=_fi_lock
        self._fi_lock = threading.Lock()
        import random

        self._fi_rng = random.Random(0xFA_017)
        # O_DIRECT|O_DSYNC fd: durable DMA writes that never touch the page
        # cache. Unavailable on some filesystems (tmpfs) — fall back to
        # buffered+fdatasync in write_durable.
        self._dfd: int | None = None
        self._dbuf: mmap.mmap | None = None  # page-aligned bounce buffer
        self._dlock = threading.Lock()
        try:
            self._dfd = os.open(
                path, os.O_RDWR | os.O_DIRECT | os.O_DSYNC
            )
        except (OSError, AttributeError):
            self._dfd = None

    @property
    def supports_direct(self) -> bool:
        return self._dfd is not None

    def read(self, offset: int, size: int) -> bytes:
        data = os.pread(self._fd, size, offset)
        if self._fi:
            data = self._fi_corrupt_read(offset, data)
        return data

    def write(self, offset: int, data: bytes) -> None:
        if self._fi:
            # Record + write under one lock: a concurrent sync() must not
            # clear the pre-image after capture but before the write
            # lands (crash() would then treat the unsynced write as
            # durable).
            with self._fi_lock:
                self._fi_record_preimage_locked(offset, len(data))
                os.pwrite(self._fd, data, offset)
            return
        os.pwrite(self._fd, data, offset)

    def write_batch(self, segments) -> None:
        """Buffered positioned writes of [(offset, data), ...] in ONE
        GIL-releasing native call when the busio shim is available
        (csrc/busio.c busio_pwritev — the WAL writer thread's header-ring
        + body segments, docs/NATIVE_DATAPATH.md), else a pwrite loop.
        Fault injection always takes the per-write path: pre-image
        capture must stay atomic with each write."""
        if self._fi:
            for offset, data in segments:
                self.write(offset, data)
            return
        from tigerbeetle_tpu_torch.net import codec

        if codec.enabled():  # the codec's one switch
            codec.pwritev(self._fd, list(segments))
            return
        for offset, data in segments:
            os.pwrite(self._fd, data, offset)

    def write_durable(self, offset: int, chunks: Sequence[bytes]) -> None:
        """Write `chunks` contiguously at `offset`, durable at return.

        Direct path: copy into the page-aligned bounce buffer, pad the
        tail to the alignment unit (slack inside the owning slot — callers
        guarantee the padded length fits), one O_DIRECT|O_DSYNC pwrite.
        Fallback: buffered pwrite + fdatasync.
        """
        total = sum(len(c) for c in chunks)
        align = self.DIRECT_ALIGN
        if self._dfd is None or offset % align:
            if self._fi:
                # Whole sequence under the lock: the whole-file fdatasync
                # makes EVERY buffered write durable, and no concurrent
                # write() may slip its pwrite between the fdatasync and
                # the pre-image clear.
                with self._fi_lock:
                    for c in chunks:
                        os.pwrite(self._fd, c, offset)
                        offset += len(c)
                    os.fdatasync(self._fd)
                    self._fi_preimage = {}
                return
            for c in chunks:
                os.pwrite(self._fd, c, offset)
                offset += len(c)
            os.fdatasync(self._fd)
            return
        if self._fi:
            # Durable-at-return: never pending in the crash model — and a
            # stale pre-image recorded for an earlier buffered write at an
            # overlapping range must not revert these bytes on crash().
            self._fi_discard_preimages(offset, total)
        padded = -(-total // align) * align
        with self._dlock:
            if self._dbuf is None or len(self._dbuf) < padded:
                self._dbuf = mmap.mmap(-1, max(padded, 1 << 20))
            pos = 0
            for c in chunks:
                self._dbuf[pos : pos + len(c)] = c
                pos += len(c)
            if padded > total:
                self._dbuf[total:padded] = b"\x00" * (padded - total)
            os.pwrite(self._dfd, memoryview(self._dbuf)[:padded], offset)
            # Belt-and-braces coherency with the buffered read fd: the
            # kernel invalidates cached pages after a direct write, but
            # open(2) warns the invalidate can fail/race a concurrent
            # buffered read — drop the range explicitly so a later pread
            # can never serve bytes from before this write.
            try:
                os.posix_fadvise(
                    self._fd, offset, padded, os.POSIX_FADV_DONTNEED
                )
            except OSError:
                pass

    def writeback_kick(self, offset: int, nbytes: int) -> None:
        """Start async writeback of a buffered range (no durability)."""
        _sync_file_range(self._fd, offset, nbytes)

    def sync(self) -> None:
        # fdatasync suffices: the file's size is fixed at format time, so
        # the only metadata updates are timestamps, which durability of the
        # data file's contents does not depend on.
        if self._fi:
            with self._fi_lock:
                os.fdatasync(self._fd)
                self._fi_preimage = {}
            return
        os.fdatasync(self._fd)

    def close(self) -> None:
        os.close(self._fd)
        if self._dfd is not None:
            os.close(self._dfd)
            self._dfd = None

    # --- fault injection (MemStorage parity; the `fault_injection` gate)

    def _fi_record_preimage_locked(self, offset: int, size: int) -> None:  # tidy: holds=_fi_lock
        """Capture the pre-write bytes of a buffered write. Pre-images
        are DISJOINT intervals of last-synced content: only the
        sub-ranges of [offset, offset+size) not already covered are read
        from disk — a range under an existing pre-image was overwritten
        since the last sync, so the file holds unsynced bytes there, and
        reading them would make crash() restore never-synced data (the
        overlapping-write / size-growing-rewrite hazard). Caller holds
        _fi_lock."""
        uncovered = [(offset, offset + size)]
        for o, pre in self._fi_preimage.items():
            lo, hi = o, o + len(pre)
            nxt = []
            for a, b in uncovered:
                if b <= lo or hi <= a:
                    nxt.append((a, b))
                    continue
                if a < lo:
                    nxt.append((a, lo))
                if hi < b:
                    nxt.append((hi, b))
            uncovered = nxt
            if not uncovered:
                return
        for a, b in uncovered:
            self._fi_preimage[a] = os.pread(self._fd, b - a, a)

    def _fi_discard_preimages(self, offset: int, size: int) -> None:
        """Trim pre-images overlapping [offset, offset+size): the range
        is durable now, so crash() must never revert it. Parts of a
        pre-image outside the durable range stay revertible (disjointness
        is preserved)."""
        lo, hi = offset, offset + size
        with self._fi_lock:
            hits = [
                (o, pre) for o, pre in self._fi_preimage.items()
                if o < hi and lo < o + len(pre)
            ]
            for o, pre in hits:
                del self._fi_preimage[o]
                if o < lo:
                    self._fi_preimage[o] = pre[: lo - o]
                if hi < o + len(pre):
                    self._fi_preimage[hi] = pre[hi - o :]

    def _fi_corrupt_read(self, offset: int, data: bytes) -> bytes:
        with self._fi_lock:
            if not self._fi_faulty:
                return data
            first = offset // SECTOR_SIZE
            last = (offset + len(data) - 1) // SECTOR_SIZE if data else first
            hit = [s for s in range(first, last + 1) if s in self._fi_faulty]
        if not hit:
            return data
        out = bytearray(data)
        for s in hit:
            lo = max(offset, s * SECTOR_SIZE)
            hi = min(offset + len(data), (s + 1) * SECTOR_SIZE)
            out[lo - offset : hi - offset] = bytes(
                b ^ 0xA5 for b in out[lo - offset : hi - offset]
            )
        return bytes(out)

    def crash(self, torn_write_probability: float = 0.5) -> None:
        """Model a power-cut/process-kill (MemStorage.crash parity):
        buffered writes since the last sync are REVERTED to their
        pre-images with `torn_write_probability` (write lost entirely),
        else they may tear at a sector boundary (the tail reverts).
        write_durable bytes are never touched. No-op when fault
        injection is disabled."""
        if not self._fi:
            return
        with self._fi_lock:
            pre, self._fi_preimage = self._fi_preimage, {}
        for offset, old in pre.items():
            r = self._fi_rng.random()
            if r < torn_write_probability:
                os.pwrite(self._fd, old, offset)  # write lost entirely
                continue
            # Write applied, possibly torn at a sector boundary: the tail
            # beyond the keep point reverts to the pre-image.
            if self._fi_rng.random() < 0.5 and len(old) > SECTOR_SIZE:
                sectors = len(old) // SECTOR_SIZE
                keep = self._fi_rng.randrange(1, sectors + 1) * SECTOR_SIZE
                if keep < len(old):
                    os.pwrite(self._fd, old[keep:], offset + keep)
        os.fdatasync(self._fd)

    def corrupt_sector(self, sector: int) -> None:
        if not self._fi:
            return
        with self._fi_lock:
            self._fi_faulty.add(sector)

    def repair_sector(self, sector: int) -> None:
        if not self._fi:
            return
        with self._fi_lock:
            self._fi_faulty.discard(sector)
