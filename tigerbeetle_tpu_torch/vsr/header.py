"""256-byte message headers with cryptographic checksums.

Mirrors the upstream extern-struct header (src/vsr/message_header.zig:
17-70): every message is a 256-byte header + ≤(1 MiB − 256 B) body;
`checksum` covers the header bytes after itself, `checksum_body` covers
the body. The same MAC seals grid blocks.

Like upstream (src/vsr/checksum.zig:1-45), the MAC is AEGIS-128L with a
zero key, via the native AES-NI shim (native/, csrc/aegis128l.c). Hosts
without the shim use BLAKE2b-128. The two are format-incompatible, and
messages, WAL entries, superblocks and grid blocks cross replicas, so
every replica of a cluster (and the data files it wrote) must have made
the same choice: a host with the shim always takes aegis128l, as the
reference package does on such a host, so the two packages' messages are
byte-identical. The choice is made once per process, at the first
checksum rather than at import, so importing the package builds nothing.
"""

from __future__ import annotations

import hashlib

import numpy as np

HEADER_SIZE = 256
CHECKSUM_SIZE = 16


class Command:
    """Message commands (reference vsr.zig:168-206, pragmatic subset)."""

    RESERVED = 0
    PING = 1
    PONG = 2
    PING_CLIENT = 3
    PONG_CLIENT = 4
    REQUEST = 5
    PREPARE = 6
    PREPARE_OK = 7
    REPLY = 8
    COMMIT = 9
    START_VIEW_CHANGE = 10
    DO_VIEW_CHANGE = 11
    START_VIEW = 12
    REQUEST_START_VIEW = 13
    REQUEST_HEADERS = 14
    REQUEST_PREPARE = 15
    # 16 (reference request_reply) is intentionally absent: replies are
    # rebuilt deterministically by WAL replay on every replica, so no
    # replica can be missing one it needs (see Zone.for_config).
    HEADERS = 17
    EVICTION = 18
    REQUEST_SYNC_CHECKPOINT = 19
    SYNC_CHECKPOINT = 20
    # Block-level state sync (reference request_blocks/block,
    # replica.zig:2289,2413): fetch exactly the grid blocks a checkpoint
    # references that the local grid is missing.
    REQUEST_BLOCKS = 21
    BLOCK = 22
    # Admission-control shed (docs/FRONT_DOOR.md): the primary's request
    # queue (or perceived-latency bound) is saturated — the client should
    # back off and RETRY the same request. Distinct from EVICTION: the
    # session stays registered and its request number is not consumed.
    # (Our addition — the reference sheds only by eviction.)
    BUSY = 23
    NAMES = {}


Command.NAMES = {
    v: k for k, v in vars(Command).items() if isinstance(v, int)
}


class Operation:
    """State-machine operations ≥ 128; control-plane < 128
    (reference vsr.zig:210, constants.zig:39)."""

    ROOT = 1
    REGISTER = 2
    # Membership change (reference vsr.Operation.reconfigure +
    # commit_reconfiguration, replica.zig:3842): body is RECONFIGURE_DTYPE
    # — promote one standby into a vacated active slot, committed through
    # the normal replication path so every replica applies it at the same
    # op.
    RECONFIGURE = 3

    CREATE_ACCOUNTS = 128
    CREATE_TRANSFERS = 129
    LOOKUP_ACCOUNTS = 130
    LOOKUP_TRANSFERS = 131
    GET_ACCOUNT_TRANSFERS = 132
    GET_ACCOUNT_HISTORY = 133
    # Index-backed equality queries (upstream TigerBeetle query_accounts /
    # query_transfers numbering; body = one QUERY_FILTER_DTYPE record).
    QUERY_ACCOUNTS = 134
    QUERY_TRANSFERS = 135

    NAMES_BY_STR = {
        "create_accounts": 128,
        "create_transfers": 129,
        "lookup_accounts": 130,
        "lookup_transfers": 131,
        "get_account_transfers": 132,
        "get_account_history": 133,
    }


# RECONFIGURE operation body: promote standby_index into active slot
# target_index (vacated by a failed member).
RECONFIGURE_DTYPE = np.dtype(
    [("standby_index", "<u4"), ("target_index", "<u4"), ("reserved", "V24")]
)
assert RECONFIGURE_DTYPE.itemsize == 32

# One layout for all commands; per-command fields are a documented union in
# the reference — here the superset is flattened (256 B total, zero-padded).
HEADER_DTYPE = np.dtype(
    [
        ("checksum_lo", "<u8"), ("checksum_hi", "<u8"),
        ("checksum_body_lo", "<u8"), ("checksum_body_hi", "<u8"),
        ("parent_lo", "<u8"), ("parent_hi", "<u8"),  # prev prepare / context
        ("client_lo", "<u8"), ("client_hi", "<u8"),
        ("cluster_lo", "<u8"), ("cluster_hi", "<u8"),
        ("size", "<u4"),
        ("epoch", "<u4"),
        ("view", "<u4"),
        ("release", "<u4"),
        ("op", "<u8"),
        ("commit", "<u8"),
        ("timestamp", "<u8"),
        ("request", "<u4"),
        ("replica", "u1"),
        ("command", "u1"),
        ("operation", "u1"),
        ("version", "u1"),
        ("checkpoint_op", "<u8"),
        ("nonce", "<u8"),
        ("reserved", "V112"),
    ]
)
assert HEADER_DTYPE.itemsize == HEADER_SIZE


def _blake2b(data) -> int:
    return int.from_bytes(
        hashlib.blake2b(bytes(data), digest_size=16).digest(), "little"
    )


def _select_checksum():
    """aegis128l when the native shim loads, else blake2b (see module
    docstring)."""
    from tigerbeetle_tpu_torch import native

    mac = native.aegis128l_mac()
    if mac is None:
        return _blake2b, "blake2b"
    mac_ptr = native.aegis128l_mac_ptr()

    def _cs(data):
        if (
            mac_ptr is not None
            and isinstance(data, np.ndarray)
            and data.flags["C_CONTIGUOUS"]
        ):
            # MAC straight over the array memory (bytes(arr) would copy a
            # client batch for nothing). Strided views take the copying
            # path: ctypes.data walks raw memory.
            return int.from_bytes(mac_ptr(data.ctypes.data, data.nbytes), "little")
        return int.from_bytes(mac(bytes(data)), "little")

    return _cs, "aegis128l"


_checksum_fn = None
CHECKSUM_ALGORITHM = None  # set at the first checksum


def checksum_algorithm() -> str:
    """The process's checksum algorithm, "aegis128l" or "blake2b",
    chosen at the first call and fixed from then on."""
    global _checksum_fn, CHECKSUM_ALGORITHM
    if _checksum_fn is None:
        _checksum_fn, CHECKSUM_ALGORITHM = _select_checksum()
    return CHECKSUM_ALGORITHM


_codec = None  # net.codec module when the native bus is enabled, else False


def _native_codec():
    """The native framed codec (net/codec.py) when enabled for this
    process, else None. Lazy: codec imports this module, so the cycle
    resolves at first call, and the probe result is cached — the hot
    encode paths pay one global read."""
    global _codec
    if _codec is None:
        from tigerbeetle_tpu_torch.net import codec

        _codec = codec if codec.enabled() else False
    return _codec or None


def checksum(data: bytes | memoryview) -> int:
    """128-bit MAC over headers, bodies, and grid blocks."""
    if _checksum_fn is None:
        checksum_algorithm()
    return _checksum_fn(data)


def _alternate_checksum(data: bytes) -> int | None:
    """The OTHER algorithm's MAC (diagnostic only): lets a replica tell
    'peer configured with the other checksum algorithm' apart from plain
    corruption — without it a mixed cluster silently drops every message
    and never forms quorum."""
    if checksum_algorithm() == "blake2b":
        from tigerbeetle_tpu_torch import native

        mac = native.aegis128l_mac()
        if mac is None:
            return None
        return int.from_bytes(mac(bytes(data)), "little")
    return _blake2b(data)


class Header:
    """Mutable view over one 256-byte header record."""

    __slots__ = ("rec",)

    def __init__(self, rec: np.ndarray | None = None, **fields) -> None:
        if rec is None:
            rec = np.zeros((), dtype=HEADER_DTYPE)
            rec["version"] = 1
            rec["size"] = HEADER_SIZE
        self.rec = rec
        for k, v in fields.items():
            self[k] = v

    def __getitem__(self, k: str) -> int:
        if k in ("checksum", "checksum_body", "parent", "client", "cluster"):
            return int(self.rec[k + "_lo"]) | (int(self.rec[k + "_hi"]) << 64)
        return int(self.rec[k])

    def __setitem__(self, k: str, v: int) -> None:
        if k in ("checksum", "checksum_body", "parent", "client", "cluster"):
            self.rec[k + "_lo"] = v & ((1 << 64) - 1)
            self.rec[k + "_hi"] = v >> 64
        else:
            self.rec[k] = v

    # --- wire ----------------------------------------------------------

    def set_checksum_body(self, body) -> None:
        """body: bytes, or a numpy array (client zero-copy path — the MAC
        runs over the array memory and the size is its byte length)."""
        nb = body.nbytes if isinstance(body, np.ndarray) else len(body)
        self["size"] = HEADER_SIZE + nb
        self["checksum_body"] = checksum(body)

    def set_checksum(self) -> None:
        self["checksum"] = checksum(self.rec.tobytes()[CHECKSUM_SIZE:])

    def valid_checksum(self) -> bool:
        return self["checksum"] == checksum(self.rec.tobytes()[CHECKSUM_SIZE:])

    def checksum_algorithm_mismatch(self) -> bool:
        """True when the header's MAC validates under the algorithm this
        host is NOT configured with: the peer (or data file) was written
        on a host that chose the other algorithm."""
        alt = _alternate_checksum(self.rec.tobytes()[CHECKSUM_SIZE:])
        return alt is not None and self["checksum"] == alt

    def valid_checksum_body(self, body: bytes) -> bool:
        if len(body) != self["size"] - HEADER_SIZE:
            return False
        return self["checksum_body"] == checksum(body)

    def to_bytes(self) -> bytes:
        return self.rec.tobytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "Header":
        assert len(data) == HEADER_SIZE
        return cls(np.frombuffer(bytearray(data), dtype=HEADER_DTYPE)[0])

    def copy(self) -> "Header":
        return Header(self.rec.copy())

    def __repr__(self) -> str:
        cmd = Command.NAMES.get(self["command"], self["command"])
        return (
            f"<Header {cmd} view={self['view']} op={self['op']} "
            f"commit={self['commit']} replica={self['replica']}>"
        )


class ReplyBuilder:
    """Reply serialization through a preallocated scratch record.

    The per-op hdr.make path allocates a fresh Header (a zeroed
    HEADER_DTYPE record) per reply; the overlapped commit stage instead
    reuses ONE scratch record — scalar stores, the two MACs, then a
    256-byte copy out (replies outlive the next build via the
    client-session cache). Byte-identical to hdr.make + Message.seal.
    """

    _U64 = (1 << 64) - 1

    def __init__(self) -> None:
        self._recs = np.zeros(1, dtype=HEADER_DTYPE)

    def build_one(self, s: dict) -> "Message":
        """s: view/op/timestamp/request/replica/operation/cluster/client
        + body (bytes) → sealed reply Message."""
        codec = _native_codec()
        if codec is not None:
            # Native encode: field stores + both MACs in one GIL-releasing
            # C call into a fresh record (replies outlive the builder, so
            # a fresh 256-byte record replaces the scratch + copy-out).
            from tigerbeetle_tpu_torch import tracer

            with tracer.span("bus.encode"):
                rec = np.empty(1, dtype=HEADER_DTYPE)
                codec.encode_header_into(
                    rec, s["body"], command=Command.REPLY,
                    cluster=s["cluster"], client=s["client"],
                    view=s["view"], op=s["op"], commit=s["op"],
                    timestamp=s["timestamp"], request=s["request"],
                    replica=s["replica"], operation=s["operation"],
                )
            return Message(Header(rec[0]), s["body"])
        self._recs[0] = np.zeros((), dtype=HEADER_DTYPE)
        rec = self._recs[0]
        rec["version"] = 1
        rec["command"] = Command.REPLY
        for field in ("view", "op", "timestamp", "request", "replica", "operation"):
            rec[field] = s[field]
        rec["commit"] = s["op"]
        rec["cluster_lo"] = s["cluster"] & self._U64
        rec["cluster_hi"] = s["cluster"] >> 64
        rec["client_lo"] = s["client"] & self._U64
        rec["client_hi"] = s["client"] >> 64
        body = s["body"]
        rec["size"] = HEADER_SIZE + len(body)
        cb = checksum(body)
        rec["checksum_body_lo"] = cb & self._U64
        rec["checksum_body_hi"] = cb >> 64
        c = checksum(rec.tobytes()[CHECKSUM_SIZE:])
        rec["checksum_lo"] = c & self._U64
        rec["checksum_hi"] = c >> 64
        return Message(Header(rec.copy()), body)


def make(command: int, cluster: int = 0, **fields) -> Header:
    h = Header()
    h["command"] = command
    h["cluster"] = cluster
    for k, v in fields.items():
        h[k] = v
    return h


def make_sealed(
    command: int, cluster: int = 0, body: bytes = b"", **fields
) -> "Message":
    """Sealed outbound frame: `make(...)` + `Message(...).seal()` fused
    through the native encoder when enabled (one C call instead of ~15
    numpy scalar stores + two ctypes MACs). Byte-identical either way —
    the hot small-frame paths (replies, BUSY sheds, pongs, client
    requests) call this."""
    codec = _native_codec()
    if codec is not None:
        return codec.encode_message(
            body, command=command, cluster=cluster, **fields
        )
    return Message(make(command, cluster, **fields), body).seal()


class Message:
    """Header + body; checksums sealed on send."""

    # lifecycle: the op's tracer.OpRecord riding WITH the message from
    # bus arrival through prepare/WAL/commit/reply (tracer.py per-op
    # lifecycle layer). None when tracing is off or the message is not a
    # tracked request/prepare; never serialized.
    # verified: both checksums already MAC-checked at the bus ingress
    # (native scan or read_message) — the replica's on_message defense
    # re-verify is skipped for these. Never serialized; copies reset it.
    __slots__ = ("header", "body", "lifecycle", "verified")

    def __init__(self, header: Header, body: bytes = b"") -> None:
        self.header = header
        self.body = body
        self.lifecycle = None
        self.verified = False

    def seal(self) -> "Message":
        self.header.set_checksum_body(self.body)
        self.header.set_checksum()
        return self

    def seal_with_body_checksum(self, checksum_body: int) -> "Message":
        """Seal reusing an already-verified body checksum (checksum once:
        a primary re-framing a client request into a prepare keeps the
        body bytes — recomputing the 1 MiB body MAC would be pure waste;
        the bus verified it on ingress)."""
        self.header["size"] = HEADER_SIZE + len(self.body)
        self.header["checksum_body"] = checksum_body
        self.header.set_checksum()
        return self

    def to_bytes(self) -> bytes:
        # join, not +: zero-copy bodies off the native receive ring are
        # memoryviews, which bytes.__add__ rejects.
        return (
            b"".join((self.header.to_bytes(), self.body))
            if self.body else self.header.to_bytes()
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "Message":
        h = Header.from_bytes(data[:HEADER_SIZE])
        return cls(h, bytes(data[HEADER_SIZE : h["size"]]))

    def verify(self) -> bool:
        return self.header.valid_checksum() and self.header.valid_checksum_body(self.body)

    def copy(self) -> "Message":
        return Message(self.header.copy(), self.body)
