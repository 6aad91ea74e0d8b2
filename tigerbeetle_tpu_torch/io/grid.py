"""Grid: write-once block storage + free set over the data file's grid zone.

The durable home of the LSM tier (reference upstream src/vsr/
grid.zig:38 + free_set.zig:20-45, radically simplified for a single-writer
host runtime): fixed-size blocks addressed by index, each sealed with a
checksum header; a numpy-bitset free set persisted EWAH-compressed
(io/ewah.py). Blocks are write-once between acquire and release — a block's
content never changes while referenced, so readers may cache by address
(the block cache below is the set-associative-cache analog, reference
set_associative_cache.zig:15, as an LRU over block indices).

Checkpoint contract: callers persist `free_set_encode()` output (plus their
own manifests) in the checkpoint snapshot; `free_set_restore()` rewinds the
allocation state on recovery, which implicitly releases blocks acquired
after the checkpoint (write-once + rewind = crash consistency without a
journal for the grid).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np

from tigerbeetle_tpu_torch import tracer
from tigerbeetle_tpu_torch.io import ewah
from tigerbeetle_tpu_torch.vsr.header import checksum as _checksum

BLOCK_HEADER_SIZE = 32
_BLOCK_HEADER_DTYPE = np.dtype(
    [
        ("checksum_lo", "<u8"), ("checksum_hi", "<u8"),
        ("size", "<u4"),  # payload bytes
        ("block_type", "<u4"),
        ("reserved", "<u8"),
    ]
)
assert _BLOCK_HEADER_DTYPE.itemsize == BLOCK_HEADER_SIZE


class GridReadFault(IOError):
    """A grid block failed its checksum on read. Carries the index and
    the expected payload checksum (from the RAM identity map; None when
    untracked) so the replica can repair the single block from a peer in
    normal operation — the reference's always-on block-repair protocol
    (grid_blocks_missing.zig:513, replica.zig:2289,2413), not a sync
    mode. Subclasses IOError so pre-existing handlers keep working."""

    def __init__(self, index: int, expected: Optional[int]) -> None:
        super().__init__(f"grid block {index} corrupt")
        self.index = int(index)
        self.expected = expected


class FreeSet:
    """Bitset allocator for grid blocks (reference free_set.zig).

    True = free. Content acquisition always takes the LOWEST free block —
    restart-invariant by construction: any two replicas whose free bits
    agree and who run the same operation sequence allocate identical
    indices, so checkpointed grid layout is byte-deterministic across the
    cluster (the storage checker compares it unconditionally). Checkpoint
    trailers allocate from the TOP (`acquire_high`) so their per-replica
    placement history never perturbs content layout.
    """

    def __init__(self, block_count: int) -> None:
        self.free = np.ones(block_count, dtype=bool)
        # Frees staged until the next checkpoint commits (write-once per
        # checkpoint epoch): blocks referenced by the last durable
        # checkpoint must not be reused before a newer checkpoint lands,
        # or crash recovery could rewind to a manifest whose blocks were
        # overwritten.
        self._staged: list[int] = []
        # Amortization hint: every index < _low is known-allocated, so
        # acquire scans from here instead of 0 (identical result sequence;
        # release/restore rewind it). Without this, lowest-free-first costs
        # O(block_count) per acquisition on a mostly-full grid.
        self._low = 0

    @property
    def free_count(self) -> int:
        return int(self.free.sum())

    def acquire(self) -> int:
        if self._low >= len(self.free):
            raise RuntimeError("grid full: no free blocks")
        off = int(np.argmax(self.free[self._low :]))
        ix = self._low + off
        if not self.free[ix]:
            raise RuntimeError("grid full: no free blocks")
        self.free[ix] = False
        self._low = ix + 1
        return ix

    def acquire_high(self) -> int:
        """Highest free block (checkpoint-trailer region)."""
        rev = int(np.argmax(self.free[::-1]))
        ix = len(self.free) - 1 - rev
        if not self.free[ix]:
            raise RuntimeError("grid full: no free blocks")
        self.free[ix] = False
        return ix

    def release(self, index: int) -> None:
        assert not self.free[index], f"double release of block {index}"
        self.free[index] = True
        self._low = min(self._low, index)

    def reserve(self, n: int) -> list:
        """Deterministically take the n LOWEST free blocks (reference
        free_set.zig:28-45 reserve→acquire→forfeit: a compaction job owns
        its output range privately, so its write order can never
        interleave with other allocations — the keystone that lets jobs
        span checkpoints without perturbing the deterministic layout).
        Unused blocks are released at forfeit (plain release())."""
        free_ix = np.nonzero(self.free[self._low :])[0] + self._low
        if len(free_ix) < n:
            raise RuntimeError("grid full: cannot reserve")
        picked = free_ix[:n]
        self.free[picked] = False
        if n:
            # The n lowest free blocks were just taken, so everything at
            # or below picked[-1] is now allocated.
            self._low = max(self._low, int(picked[-1]) + 1)
        return [int(i) for i in picked]

    def stage_release(self, index: int) -> None:
        assert not self.free[index], f"double release of block {index}"
        self._staged.append(index)

    def commit_staged(self) -> None:
        """Apply staged frees — call only after the superseding checkpoint
        is durable."""
        for i in self._staged:
            self.free[i] = True
            self._low = min(self._low, i)
        self._staged = []

    def encode(self) -> bytes:
        """Snapshot the allocation state as it will stand once this
        checkpoint is durable (staged frees applied)."""
        bits = self.free.copy()
        if self._staged:
            bits[np.array(self._staged, dtype=np.int64)] = True
        return ewah.encode(ewah.bitset_to_words(bits))

    def restore(self, data: bytes) -> None:
        n = len(self.free)
        words = ewah.decode(data, -(-n // ewah.WORD_BITS))
        self.free = ewah.words_to_bitset(words, n)
        self._staged = []
        self._low = 0


class Grid:
    """Checksummed write-once blocks over a storage zone range.

    `storage` is any object with read/write/sync (io/storage.py); offsets
    are absolute. A small LRU cache holds decoded payloads of hot blocks
    (index blocks, tail data blocks).
    """

    def __init__(
        self,
        storage,
        offset: int,
        block_count: int,
        block_size: int,
        cache_blocks: int = 64,
        defer_releases: bool = False,
    ) -> None:
        assert block_size > BLOCK_HEADER_SIZE
        self.storage = storage
        self.offset = offset
        self.block_size = block_size
        self.block_count = block_count
        # Checkpointing owners (the replica) defer frees until the
        # superseding checkpoint is durable; standalone users free eagerly.
        self.defer_releases = defer_releases
        self.free_set = FreeSet(block_count)
        # tidy: atomic — lock-free by design: each OrderedDict op is GIL-atomic; composed sequences tolerate interleaving via KeyError guards (acceleration, never source of truth)
        self._cache: OrderedDict[int, bytes] = OrderedDict()
        self._cache_blocks = cache_blocks
        # RAM map of each written block's payload checksum — the identity
        # side of block-level state sync (a checkpoint publishes
        # (index, checksum) pairs; peers fetch only blocks whose local
        # checksum differs). Restored from the checkpoint blob at open.
        # tidy: atomic — GIL-atomic single-key dict ops; a write-once block's entry is published before any reader learns its index
        self.block_cks: dict[int, int] = {}
        self.reads = 0  # tidy: atomic — stats counter, lost updates benign
        self.writes = 0  # tidy: atomic — stats counter, lost updates benign
        self.cache_hits = 0  # tidy: atomic — stats counter, lost updates benign

    @property
    def payload_max(self) -> int:
        return self.block_size - BLOCK_HEADER_SIZE

    def _addr(self, index: int) -> int:
        assert 0 <= index < self.block_count
        return self.offset + index * self.block_size

    def write_block(self, payload: bytes, block_type: int = 0) -> int:
        """Acquire a free block, write header+payload, return its index.

        No sync — callers batch-sync at durability points (checkpoint);
        write-once + free-set rewind keeps crashes consistent.
        """
        assert len(payload) <= self.payload_max, (
            f"payload {len(payload)} > {self.payload_max}"
        )
        index = self.free_set.acquire()
        head = np.zeros((), dtype=_BLOCK_HEADER_DTYPE)
        head["size"] = len(payload)
        head["block_type"] = block_type
        c = _checksum(payload)
        head["checksum_lo"] = c & ((1 << 64) - 1)
        head["checksum_hi"] = c >> 64
        self.storage.write(self._addr(index), head.tobytes() + payload)
        # Start async writeback NOW: with the WAL on direct IO the data
        # file is no longer fdatasync'd per prepare, so without pacing
        # dirty grid pages would pile up until the next checkpoint's sync
        # and stall it (no durability implied — checkpoint still syncs).
        kick = getattr(self.storage, "writeback_kick", None)
        if kick is not None:
            kick(self._addr(index), self.block_size)
        self.writes += 1
        tracer.count("grid.writes")
        self.block_cks[index] = c
        self._cache_put(index, bytes(payload))
        return index

    def write_block_at(self, index: int, payload: bytes, block_type: int = 0) -> None:
        """Write a specific PRE-ACQUIRED block (checkpoint trailer chunks:
        the block set is reserved first so the encoded free set can account
        for it, then each chunk lands in its reserved slot)."""
        assert len(payload) <= self.payload_max
        assert not self.free_set.free[index], f"block {index} not acquired"
        head = np.zeros((), dtype=_BLOCK_HEADER_DTYPE)
        head["size"] = len(payload)
        head["block_type"] = block_type
        c = _checksum(payload)
        head["checksum_lo"] = c & ((1 << 64) - 1)
        head["checksum_hi"] = c >> 64
        self.storage.write(self._addr(index), head.tobytes() + payload)
        self.writes += 1
        tracer.count("grid.writes")
        self.block_cks[index] = c
        self._cache_put(index, bytes(payload))

    def read_block(self, index: int) -> bytes:
        """Return the payload; raises GridReadFault on checksum mismatch
        (corrupt block) — the replica repairs the block from a peer in
        normal operation (reference grid_blocks_missing.zig:513)."""
        cached = self._cache.get(index)
        if cached is not None:
            try:
                self._cache.move_to_end(index)
            except KeyError:
                pass  # concurrently evicted: the payload is still valid
            self.cache_hits += 1
            tracer.count("grid.cache_hits")
            return cached
        raw = self.storage.read(self._addr(index), self.block_size)
        self.reads += 1
        tracer.count("grid.reads")
        head = np.frombuffer(raw[:BLOCK_HEADER_SIZE], dtype=_BLOCK_HEADER_DTYPE)[0]
        size = int(head["size"])
        payload = raw[BLOCK_HEADER_SIZE : BLOCK_HEADER_SIZE + size]
        want = int(head["checksum_lo"]) | (int(head["checksum_hi"]) << 64)
        if size > self.payload_max or _checksum(payload) != want:
            tracer.count("grid.read_faults")
            raise GridReadFault(index, self.block_cks.get(index))
        self._cache_put(index, payload)
        return payload

    def read_block_typed(self, index: int) -> tuple[bytes, int]:
        """(payload, block_type) — the serve side of block-level sync
        needs the stored type so the receiver can rewrite the block
        byte-identically."""
        raw = self.storage.read(self._addr(index), self.block_size)
        head = np.frombuffer(raw[:BLOCK_HEADER_SIZE], dtype=_BLOCK_HEADER_DTYPE)[0]
        size = int(head["size"])
        payload = raw[BLOCK_HEADER_SIZE : BLOCK_HEADER_SIZE + size]
        want = int(head["checksum_lo"]) | (int(head["checksum_hi"]) << 64)
        if size > self.payload_max or _checksum(payload) != want:
            raise IOError(f"grid block {index} corrupt")
        return payload, int(head["block_type"])

    def local_checksum(self, index: int) -> Optional[int]:
        """The payload checksum of the block currently stored at `index`,
        or None if the block is torn/corrupt/empty. Reads through to disk
        (sync verification must see what a restart would)."""
        try:
            raw = self.storage.read(self._addr(index), self.block_size)
        except OSError:
            return None
        head = np.frombuffer(raw[:BLOCK_HEADER_SIZE], dtype=_BLOCK_HEADER_DTYPE)[0]
        size = int(head["size"])
        if size > self.payload_max:
            return None
        payload = raw[BLOCK_HEADER_SIZE : BLOCK_HEADER_SIZE + size]
        want = int(head["checksum_lo"]) | (int(head["checksum_hi"]) << 64)
        if _checksum(payload) != want:
            return None
        return want

    def release(self, index: int) -> None:
        if self.defer_releases:
            self.free_set.stage_release(index)
        else:
            self.free_set.release(index)
        self._cache.pop(index, None)

    def abort_block(self, index: int) -> None:
        """IMMEDIATELY un-acquire a freshly written, never-referenced
        block (an aborted compaction job's output). Unlike release(),
        never staged: the retried job must re-acquire the exact same
        indices (lowest-free-first) for deterministic layout."""
        self.free_set.release(index)
        self._cache.pop(index, None)
        self.block_cks.pop(index, None)

    def commit_releases(self) -> None:
        self.free_set.commit_staged()

    def _cache_put(self, index: int, payload: bytes) -> None:
        # Tolerant of concurrent use by the commit thread and the async
        # store stage: each OrderedDict operation is GIL-atomic, and the
        # composed sequences only ever fail with KeyError when the two
        # threads interleave (entry evicted between ops) — the cache is
        # acceleration, never the source of truth.
        self._cache[index] = payload
        try:
            self._cache.move_to_end(index)
        except KeyError:
            pass
        while len(self._cache) > self._cache_blocks:
            try:
                self._cache.popitem(last=False)
            except KeyError:
                break

    def drop_cache(self) -> None:
        self._cache.clear()

    def cache_contains(self, index: int) -> bool:
        """True when the block's payload is LRU-resident — a read would
        be RAM-speed rather than a storage read + checksum verify. Cost
        signal only (the scan planner's fetch costing); never correctness."""
        return index in self._cache


class MemGrid(Grid):
    """Grid over a lazy in-memory page map (no Zone needed) — the default
    backing for a StateMachine constructed without durable storage (tests,
    benchmarks, the simulator's non-crash paths). Lazy so a production-
    sized grid (GiBs of address space) costs only what is written."""

    class _Buf:
        """Sparse write-granularity page store; the grid only ever writes a
        whole block at its base offset and reads whole blocks back."""

        def __init__(self) -> None:
            self.pages: dict[int, bytes] = {}

        def read(self, offset: int, size: int) -> bytes:
            data = self.pages.get(offset, b"")
            return data[:size].ljust(size, b"\x00")

        def write(self, offset: int, data: bytes) -> None:
            self.pages[offset] = bytes(data)

        def sync(self) -> None:
            pass

    def __init__(self, block_count: int, block_size: int, cache_blocks: int = 64) -> None:
        super().__init__(MemGrid._Buf(), 0, block_count, block_size, cache_blocks)
