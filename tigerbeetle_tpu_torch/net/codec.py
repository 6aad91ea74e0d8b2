"""Native framed-message codec: the C front-door datapath.

Python wrapper over csrc/busio.c (docs/NATIVE_DATAPATH.md): batch frame
scan + checksum verify over a contiguous receive buffer, zero-alloc
header encode, wire-AoS -> device-SoA transfer decode, and the WAL
ring's batched positioned writes — each a single GIL-releasing ctypes
call, replacing per-message Python byte work on the asyncio loop
thread.

Selection is the reference package's adaptive rule: native when the
extension builds AND the cluster checksum is aegis128l (the codec
verifies AEGIS MACs in C). The port reads no environment variable, so
there is no override. The pure-Python encoding stays byte-identical and
is used everywhere the codec is not enabled.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from typing import List, Optional, Tuple

import numpy as np

from tigerbeetle_tpu_torch.vsr.header import (
    HEADER_DTYPE,
    HEADER_SIZE,
    Header,
    Message,
    checksum_algorithm,
)

# busio_scan SoA columns per frame (csrc/busio.c BUSIO_SCAN_COLS).
SCAN_COLS = 8
COL_OFFSET, COL_SIZE, COL_COMMAND, COL_CLIENT_LO = 0, 1, 2, 3
COL_CLIENT_HI, COL_REQUEST, COL_REPLICA, COL_OPERATION = 4, 5, 6, 7

# Scan statuses (tail[2]).
STATUS_OK = 0  # every complete frame parsed; tail (if any) is incomplete
STATUS_HEADER_MAC = 1
STATUS_SIZE = 2
STATUS_BODY_MAC = 3

# One shared scratch sized for the worst legal scan: the reader joins at
# most one incomplete frame (< STREAM_LIMIT = 2 MiB) + one read chunk, so
# the frame count is bounded by that length / HEADER_SIZE. All scans run
# on the event-loop thread and consume their rows before returning, so a
# single scratch serves every connection (10k-session front door: no
# per-connection MiB).
SCAN_MAX_FRAMES = 16384

_lib = None
_resolved = False


def _resolve():
    """Load csrc/busio.c once. Returns the ctypes lib or None (the
    pure-Python path)."""
    global _lib, _resolved
    if _resolved:
        return _lib
    _resolved = True
    if checksum_algorithm() != "aegis128l":
        # The C scanner verifies AEGIS MACs; a blake2b cluster keeps the
        # Python parser or every inbound frame would be rejected.
        return None
    from tigerbeetle_tpu_torch import native

    _lib = native.busio()
    return _lib


def enabled() -> bool:
    """Is the native datapath active for this process?"""
    return _resolve() is not None


class FrameScanner:
    """Reusable scan scratch + ctypes plumbing (one per event loop)."""

    __slots__ = ("_lib", "_out", "_outp", "_tail", "_tailp")

    def __init__(self) -> None:
        lib = _resolve()
        assert lib is not None, "codec disabled — guard with codec.enabled()"
        self._lib = lib
        u64p = ctypes.POINTER(ctypes.c_uint64)
        self._out = np.empty((SCAN_MAX_FRAMES, SCAN_COLS), dtype=np.uint64)
        self._outp = self._out.ctypes.data_as(u64p)
        self._tail = np.empty(3, dtype=np.uint64)
        self._tailp = self._tail.ctypes.data_as(u64p)

    def scan(self, buf: bytes) -> Tuple[np.ndarray, int, int, int]:
        """Parse + verify every complete frame in `buf` in ONE
        GIL-releasing C call. Returns (rows, consumed, need, status):
        rows is an (n, SCAN_COLS) u64 view of the shared scratch (consume
        before the next scan), consumed the byte offset of the first
        incomplete/invalid frame, need the total buffer length required
        for the next frame to complete, status a STATUS_* code."""
        n = self._lib.busio_scan(
            buf, len(buf), self._outp, SCAN_MAX_FRAMES, self._tailp
        )
        return (
            self._out[:n],
            int(self._tail[0]),
            int(self._tail[1]),
            int(self._tail[2]),
        )


def messages_from_scan(buf: bytes, rows: np.ndarray) -> List[Message]:
    """Materialize scanned frames as Messages. Headers are small mutable
    copies (Header.from_bytes semantics); bodies are ZERO-COPY
    memoryviews into `buf` — the buffer is immutable and stays alive via
    the views, so no per-frame body bytes are ever copied (asserted by
    tests/test_native_bus.py). Both checksums were verified by the C
    scan, so each message is marked `verified` and the replica's ingress
    re-verify is skipped."""
    out: List[Message] = []
    mv = memoryview(buf)
    for i in range(len(rows)):
        off = int(rows[i, COL_OFFSET])
        size = int(rows[i, COL_SIZE])
        rec = np.frombuffer(
            bytearray(buf[off : off + HEADER_SIZE]), dtype=HEADER_DTYPE
        )[0]
        body = mv[off + HEADER_SIZE : off + size] if size > HEADER_SIZE else b""
        m = Message(Header(rec), body)
        m.verified = True
        out.append(m)
    return out


def decode_frame(data: bytes) -> Optional[Message]:
    """One-frame decode+verify (the packet-simulator ingress and unit
    harnesses): native scan when enabled, else the unverified
    Message.from_bytes (the replica's on_message verify covers it, as
    today). None when the native scan rejects the frame."""
    lib = _resolve()
    if lib is None:
        return Message.from_bytes(data)
    sc = _thread_scanner()
    rows, consumed, _need, status = sc.scan(data)
    if len(rows) == 0:
        return None
    msgs = messages_from_scan(data, rows[:1])
    return msgs[0]


_scanner_tls = threading.local()


def _thread_scanner() -> FrameScanner:
    """This thread's scanner (thread-local scratch): every scan consumes
    its rows synchronously before the next scan ON ITS THREAD, but
    busio_scan releases the GIL, so two event loops on different
    threads (multi-threaded embedders) must never share one row
    buffer — a concurrent scan would mis-slice frames that then skip
    the MAC re-verify via `verified`."""
    sc = getattr(_scanner_tls, "scanner", None)
    if sc is None:
        sc = _scanner_tls.scanner = FrameScanner()
    return sc


def scanner() -> Optional[FrameScanner]:
    """A FrameScanner when the native path is enabled, else None."""
    return _thread_scanner() if enabled() else None


# --- encode ----------------------------------------------------------------

_U64 = (1 << 64) - 1
# busio_encode_frame's packed parameter block: one struct.pack + one
# pointer marshaled per call instead of 17 ctypes scalar conversions.
_ENC_PARAMS = struct.Struct("<14Q")


def encode_header_into(
    rec: np.ndarray,
    body: bytes,
    *,
    command: int,
    cluster: int = 0,
    client: int = 0,
    view: int = 0,
    op: int = 0,
    commit: int = 0,
    timestamp: int = 0,
    request: int = 0,
    replica: int = 0,
    operation: int = 0,
    parent: int = 0,
) -> None:
    """Fill + seal one 256-byte header record in a single C call
    (field stores, body MAC, header MAC). Byte-identical to
    hdr.make(...) + Message.seal() — pinned by the golden-vector checks
    in tools/check.py and tests/test_native_bus.py. `body` may be bytes
    or a C-contiguous numpy array (the client's zero-copy batch path —
    the MAC runs straight over the array memory)."""
    lib = _resolve()
    if isinstance(body, np.ndarray):
        assert body.flags["C_CONTIGUOUS"]
        bptr, blen = ctypes.c_char_p(body.ctypes.data), body.nbytes
    else:
        if not isinstance(body, bytes):
            # memoryview/bytearray bodies: c_char_p only takes bytes —
            # the Python fallback (make+seal) accepts any buffer, and
            # the two datapaths must not diverge for the same caller.
            body = bytes(body)
        bptr, blen = body, len(body)
    lib.busio_encode_frame(
        ctypes.cast(rec.ctypes.data, ctypes.POINTER(ctypes.c_uint8)),
        bptr, blen,
        _ENC_PARAMS.pack(
            command, operation, view, op, commit, timestamp, request,
            replica, cluster & _U64, cluster >> 64, client & _U64,
            client >> 64, parent & _U64, parent >> 64,
        ),
    )


def encode_message(body: bytes = b"", **fields) -> Message:
    """Sealed outbound Message through the native encoder (fresh header
    record — for replies that outlive the builder, sheds, pongs, client
    requests)."""
    rec = np.empty(1, dtype=HEADER_DTYPE)
    encode_header_into(rec, body, **fields)
    return Message(Header(rec[0]), body)


# --- transfer SoA decode ---------------------------------------------------


def decode_transfers_into(
    events: np.ndarray,
    ts_base: int,
    dr_slots: np.ndarray,
    cr_slots: np.ndarray,
    out: dict,
    n: int,
) -> None:
    """Wire AoS transfer records -> the device kernel's preallocated SoA
    columns (u128 fields as (n,4) u32 limbs, timestamps derived from
    ts_base, narrow fields widened) in one GIL-releasing pass — the
    native twin of the ~10 strided-field numpy reads in
    StateMachine._device_batch. Writes rows [0, n) of each column; the
    caller owns bucket padding."""
    lib = _resolve()
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.busio_decode_transfers(
        ctypes.c_char_p(events.ctypes.data), n, events.strides[0],
        int(ts_base),
        dr_slots.ctypes.data_as(i64p), cr_slots.ctypes.data_as(i64p),
        out["id"].ctypes.data_as(u32p),
        out["amount"].ctypes.data_as(u32p),
        out["pending_id"].ctypes.data_as(u32p),
        out["dr_slot"].ctypes.data_as(i32p),
        out["cr_slot"].ctypes.data_as(i32p),
        out["timeout"].ctypes.data_as(u32p),
        out["ledger"].ctypes.data_as(u32p),
        out["code"].ctypes.data_as(u32p),
        out["flags"].ctypes.data_as(u32p),
        out["timestamp"].ctypes.data_as(u32p),
    )


# --- WAL ring writes -------------------------------------------------------


def pwritev(fd: int, segments) -> None:
    """Positioned writes of `[(offset, data), ...]` in one GIL-releasing
    call (the WalWriter thread's header-ring + body segments). Raises
    OSError on the first failed write, like os.pwrite."""
    lib = _resolve()
    n = len(segments)
    bufs = (ctypes.c_char_p * n)()
    lens = (ctypes.c_uint64 * n)()
    offs = (ctypes.c_uint64 * n)()
    for i, (off, data) in enumerate(segments):
        if not isinstance(data, bytes):
            data = bytes(data)
            segments[i] = (off, data)  # keep the buffer alive for the call
        bufs[i] = data
        lens[i] = len(data)
        offs[i] = off
    rc = lib.busio_pwritev(
        fd, n, bufs,
        ctypes.cast(lens, ctypes.POINTER(ctypes.c_uint64)),
        ctypes.cast(offs, ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc < 0:
        raise OSError(-rc, os.strerror(-rc))


# --- golden-vector self-check ----------------------------------------------


def golden_check() -> List[str]:
    """Cross-check the C codec against the pure-Python reference on
    fixed vectors: encode bytes, scan parse results + statuses
    (truncation, header/body corruption), and the transfer SoA decode.
    Returns failure strings (empty = in sync). Run by tools/check.py's
    codec build-probe pass and tests/test_native_bus.py — csrc/ drifting
    from the Python encoding fails CI, not production."""
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.vsr import header as hdr
    from tigerbeetle_tpu_torch.vsr.header import Command

    if not enabled():
        return ["codec not enabled (guard with codec.enabled())"]
    fails: List[str] = []
    body = bytes(range(256)) * 3 + b"tail"
    fields = dict(
        command=Command.REQUEST, cluster=(7 << 64) | 9,
        client=(1 << 126) | 0xABC, view=3, op=77, commit=70,
        timestamp=1_234_567_890, request=41, replica=2, operation=129,
        parent=(1 << 80) | 5,
    )
    py = Message(
        hdr.make(
            fields["command"], fields["cluster"],
            **{k: v for k, v in fields.items()
               if k not in ("command", "cluster")},
        ),
        body,
    ).seal()
    c = encode_message(body, **fields)
    if py.to_bytes() != c.to_bytes():
        fails.append("encode_message drifted from hdr.make + Message.seal")

    empty = Message(hdr.make(Command.PING, 0, replica=1)).seal()
    stream = py.to_bytes() + empty.to_bytes() + py.to_bytes()[:100]
    rows, consumed, _need, status = _thread_scanner().scan(stream)
    if (
        len(rows) != 2 or status != STATUS_OK
        or consumed != py.header["size"] + HEADER_SIZE
    ):
        fails.append(f"scan parse drifted: n={len(rows)} status={status}")
    else:
        m0, m1 = messages_from_scan(stream, rows)
        if m0.to_bytes() != py.to_bytes() or m1.to_bytes() != empty.to_bytes():
            fails.append("scanned frames differ from the Python reference")
    corrupt = bytearray(py.to_bytes())
    corrupt[HEADER_SIZE + 10] ^= 0xA5  # body byte
    rows, _c, _n, status = _thread_scanner().scan(bytes(corrupt))
    if len(rows) != 0 or status != STATUS_BODY_MAC:
        fails.append(f"corrupt body not rejected (status={status})")
    corrupt = bytearray(py.to_bytes())
    corrupt[40] ^= 1  # header byte (covered by the header MAC)
    rows, _c, _n, status = _thread_scanner().scan(bytes(corrupt))
    if len(rows) != 0 or status != STATUS_HEADER_MAC:
        fails.append(f"corrupt header not rejected (status={status})")

    rng = np.random.default_rng(0xC0DEC)
    n = 37
    ev = np.zeros(n, dtype=types.TRANSFER_DTYPE)
    for f in ev.dtype.names:
        info = np.iinfo(ev.dtype[f])
        ev[f] = rng.integers(0, int(info.max), n, dtype=np.uint64).astype(
            ev.dtype[f]
        )
    ts_base = 10_000
    ts = np.uint64(ts_base) + np.arange(n, dtype=np.uint64)
    dr = rng.integers(-1, 1 << 30, n).astype(np.int64)
    cr = rng.integers(-1, 1 << 30, n).astype(np.int64)
    cols = {
        "id": np.empty((n, 4), np.uint32),
        "amount": np.empty((n, 4), np.uint32),
        "pending_id": np.empty((n, 4), np.uint32),
        "dr_slot": np.empty(n, np.int32),
        "cr_slot": np.empty(n, np.int32),
        "timeout": np.empty(n, np.uint32),
        "ledger": np.empty(n, np.uint32),
        "code": np.empty(n, np.uint32),
        "flags": np.empty(n, np.uint32),
        "timestamp": np.empty((n, 2), np.uint32),
    }
    decode_transfers_into(ev, ts_base, dr, cr, cols, n)
    ref = {
        "id": types.u64_pair_to_limbs(ev["id_lo"], ev["id_hi"]),
        "amount": types.u64_pair_to_limbs(ev["amount_lo"], ev["amount_hi"]),
        "pending_id": types.u64_pair_to_limbs(
            ev["pending_id_lo"], ev["pending_id_hi"]
        ),
        "dr_slot": dr.astype(np.int32),
        "cr_slot": cr.astype(np.int32),
        "timeout": ev["timeout"].astype(np.uint32),
        "ledger": ev["ledger"].astype(np.uint32),
        "code": ev["code"].astype(np.uint32),
        "flags": ev["flags"].astype(np.uint32),
        "timestamp": types.u64_to_limbs(ts),
    }
    for name, want in ref.items():
        if not np.array_equal(cols[name], want):
            fails.append(f"decode_transfers column {name!r} drifted")
    return fails
