"""AOF: append-only file of committed prepares (disaster recovery).

The analog of upstream src/aof.zig:23-50: every committed prepare is
appended (magic-delimited, checksummed, alignment-padded) to a separate
file, hooked at commit time (replica.zig:3745). If consensus state is lost
beyond repair, `merge()` combines the surviving replicas' AOFs into one
contiguous op sequence and `recover()` replays it into a fresh state
machine — the Redis-style last-resort restore, validated byte-for-byte by
tests/test_torch_aof.py against the original cluster's state.

Entry layout (little-endian):
    magic    u128  — fixed random marker; recovery scans for it to skip
                     over torn/corrupt regions (aof.zig magic_number)
    size     u32   — message bytes that follow the 48-byte entry header
    primary  u32   — view's primary when committed (metadata)
    replica  u64   — writer replica index
    checksum u128  — MAC of the message bytes
    message  [size]u8 (sealed prepare: 256-byte header + body)
    padding to the 64-byte alignment boundary
"""

from __future__ import annotations

import logging
import os
import struct
from typing import Iterator, List, Optional, Tuple

from tigerbeetle_tpu_torch.vsr.header import Message, checksum

log = logging.getLogger("tigerbeetle_tpu_torch.aof")

MAGIC = 0x41EB00F5_0AF0FEED_C0FFEE00_7B5B71E5
_MAGIC_BYTES = MAGIC.to_bytes(16, "little")
_HEAD = struct.Struct("<IIQ")  # size, primary, replica
ALIGN = 64
ENTRY_HEADER_SIZE = 16 + _HEAD.size + 16  # magic + head + checksum


class AOF:
    """Append-only writer (one per replica process).

    Reopening scans the existing file for the highest op recorded in an
    unbroken run from the start: WAL replay after a restart re-offers every
    op since the checkpoint, and append() uses the mark to skip ops already
    recorded while still writing ones a lost page-cache tail left as a gap
    (duplicates past the mark are fine — merge() dedups by op).
    """

    def __init__(self, path: str) -> None:
        self.path = path
        # The file legitimately starts past op 1 when this replica joined
        # via state sync (it never executed the pre-checkpoint prefix), so
        # anchor the contiguity mark at the first readable entry and track
        # it: a replayed op BELOW the anchor is evidence the original
        # first entries were lost to corruption — those are re-appended
        # (gap heal; merge() dedups), everything in [first, mark] is
        # skipped as already recorded.
        self._first_op = None
        self._last_contiguous = 0
        if os.path.exists(path) and os.path.getsize(path):
            expect = None
            for m, _, _ in iter_entries(path):
                op = m.header["op"]
                if expect is None:
                    self._first_op = op
                elif op != expect:
                    break
                self._last_contiguous = op
                expect = op + 1
        self._f = open(path, "ab")

    def append(self, prepare: Message, primary: int, replica: int) -> None:
        op = prepare.header["op"]
        if (
            self._first_op is not None
            and self._first_op <= op <= self._last_contiguous
        ):
            return  # already durably recorded before a restart
        msg = prepare.to_bytes()
        entry = (
            _MAGIC_BYTES
            + _HEAD.pack(len(msg), primary, replica)
            + checksum(msg).to_bytes(16, "little")
            + msg
        )
        pad = (-len(entry)) % ALIGN
        self._f.write(entry + b"\x00" * pad)
        # Flush to the OS per entry (survives process death; fsync — which
        # survives power loss — happens at checkpoint via sync()).
        self._f.flush()

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.close()


def iter_entries(path: str) -> Iterator[Tuple[Message, int, int]]:
    """Yield (prepare, primary, replica) from an AOF, skipping corrupt
    regions by scanning forward for the magic marker (aof.zig's
    extreme-corruption recovery). The file is memory-mapped, not slurped —
    AOFs grow without bound and replicas rescan them at every start."""
    import mmap

    with open(path, "rb") as f:
        try:
            data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:  # empty file
            return
    pos = 0
    n = len(data)
    while pos + ENTRY_HEADER_SIZE <= n:
        if data[pos : pos + 16] != _MAGIC_BYTES:
            nxt = data.find(_MAGIC_BYTES, pos + 1)
            if nxt < 0:
                return
            pos = nxt
            continue
        size, primary, replica = _HEAD.unpack_from(data, pos + 16)
        want = int.from_bytes(data[pos + 16 + _HEAD.size : pos + ENTRY_HEADER_SIZE], "little")
        body_at = pos + ENTRY_HEADER_SIZE
        if body_at + size > n:
            # Either a genuinely torn tail or a FALSE magic match inside a
            # message body (a u128 field can equal MAGIC) — resync; only a
            # missing next marker means true end-of-file.
            nxt = data.find(_MAGIC_BYTES, pos + 1)
            if nxt < 0:
                return
            pos = nxt
            continue
        msg = data[body_at : body_at + size]
        if checksum(msg) != want:
            nxt = data.find(_MAGIC_BYTES, pos + 1)
            if nxt < 0:
                return
            pos = nxt
            continue
        m = Message.from_bytes(bytearray(msg))
        if m.verify():
            yield m, primary, replica
        step = ENTRY_HEADER_SIZE + size
        pos += step + ((-step) % ALIGN)


def merge(paths: List[str]) -> List[Message]:
    """Merge several replicas' AOFs into one contiguous committed sequence
    (reference `aof merge`): entries dedup by op; at conflicting content
    for one op (possible only for never-committed divergent suffixes that
    a crashed writer logged), the chain-consistent one — whose parent
    checksum matches op-1's — wins."""
    by_op: dict[int, Message] = {}
    candidates: dict[int, List[Tuple[Message, int]]] = {}
    for fi, path in enumerate(paths):
        for m, _, _ in iter_entries(path):
            op = m.header["op"]
            candidates.setdefault(op, []).append((m, fi))
    for op in sorted(candidates):
        opts = candidates[op]
        chosen: Optional[Message] = None
        prev = by_op.get(op - 1)
        for m, _fi in opts:
            if prev is None or m.header["parent"] == prev.header["checksum"]:
                chosen = m
                break
        if chosen is None:
            # Parent chain broken for every candidate — legitimate for
            # committed prepares re-sealed across views (the seal checksum
            # differs between original and re-proposed headers). Prefer
            # the content the MOST REPLICAS recorded (majority of distinct
            # source files per body checksum — one file re-appending an op
            # across views must not outvote other replicas), and log the
            # ambiguity.
            votes: dict[int, set] = {}
            for m, fi in opts:
                votes.setdefault(m.header["checksum_body"], set()).add(fi)
            best = max(len(v) for v in votes.values())
            if len(votes) > 1:
                log.warning(
                    "aof merge: op %d has %d divergent bodies across files "
                    "(no parent-chain match); choosing the majority "
                    "(%d/%d files)", op, len(votes), best, len(paths),
                )
            for m, _fi in opts:
                if len(votes[m.header["checksum_body"]]) == best:
                    chosen = m
                    break
        by_op[op] = chosen
    ops = sorted(by_op)
    # Contiguity: stop at the first gap (a gap means no surviving AOF holds
    # that op — everything after it is unrecoverable in order).
    out: List[Message] = []
    expect = ops[0] if ops else 0
    for op in ops:
        if op != expect:
            break
        out.append(by_op[op])
        expect += 1
    return out


def recover(paths: List[str], config=None, device=None, on_result=None):
    """Replay merged AOFs into a fresh state machine (reference AOF
    validator), each prepare at its own timestamp. The machine runs on
    the CUDA card unless `device="cpu"` (then every kernel's plain
    version), and raises where there is no card. `on_result(header,
    results)` receives each create's result array, so a caller can hold
    a live cluster's replies to the replay's. Returns (state_machine,
    last_op)."""
    import numpy as np

    from tigerbeetle_tpu_torch.constants import TEST_MIN
    from tigerbeetle_tpu_torch.models.state_machine import StateMachine
    from tigerbeetle_tpu_torch.vsr.header import Operation
    from tigerbeetle_tpu_torch.vsr.replica import _event_dtype

    sm = StateMachine(config or TEST_MIN, device=device)
    msgs = merge(paths)
    if msgs and msgs[0].header["op"] > 1:
        raise RuntimeError(
            f"AOF history starts at op {msgs[0].header['op']}, not op 1 — "
            "ops before it were never logged (or their entries were lost); "
            "recovery from these files alone would silently drop state"
        )
    last_op = 0
    for m in msgs:
        h = m.header
        operation = h["operation"]
        if operation < 128:
            last_op = h["op"]
            continue
        events = np.frombuffer(bytearray(m.body), dtype=_event_dtype(operation))
        results = None
        if operation == Operation.CREATE_ACCOUNTS:
            results = sm.create_accounts(events, timestamp=h["timestamp"])
            sm.prepare_timestamp = max(sm.prepare_timestamp, h["timestamp"])
        elif operation == Operation.CREATE_TRANSFERS:
            results = sm.create_transfers(events, timestamp=h["timestamp"])
            sm.prepare_timestamp = max(sm.prepare_timestamp, h["timestamp"])
        # read ops have no state effect
        if results is not None and on_result is not None:
            on_result(h, results)
        last_op = h["op"]
    return sm, last_op
