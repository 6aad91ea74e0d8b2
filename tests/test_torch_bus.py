"""The port's message bus (net/bus.py) against the reference package's.

Both frame sources (the C scanner's and the Python parser's) of both
packages read the same messages off one byte stream however it is split;
a corrupt frame ends the stream at the same place with the same counter;
`NetFault` parses a spec and schedules its faults alike for a seed; and
three of the port's replicas serving TCP replicate and converge.
"""

import asyncio
import time
from types import SimpleNamespace

import numpy as np
import pytest

from frontdoor_servers import (
    PORT,
    REFERENCE,
    ServerThread,
    account_records,
    free_port,
    mod,
    seeded_transfers,
    transfer_records,
)


def _frames(rng, n=5):
    hdr = mod(REFERENCE, "vsr.header")
    out = []
    for _ in range(n):
        body = bytes(rng.integers(0, 256, int(rng.choice([0, 1, 16, 200])), dtype=np.uint8))
        out.append(hdr.make_sealed(
            int(rng.choice([hdr.Command.REQUEST, hdr.Command.REPLY, hdr.Command.PING])), 3,
            body=body, client=int(rng.integers(0, 1 << 62)),
            request=int(rng.integers(0, 1 << 31)), operation=int(rng.integers(0, 136)),
            view=int(rng.integers(0, 1 << 20)), op=int(rng.integers(0, 1 << 40)),
            replica=int(rng.integers(0, 6)),
        ).to_bytes())
    return out


class _Reader:
    """StreamReader stand-in replaying a fixed chunk script (both the
    native source's read() and read_message's readexactly())."""

    def __init__(self, chunks):
        self._buf = bytearray()
        self._chunks = [c for c in chunks if c]

    async def read(self, n):
        if not self._buf and self._chunks:
            self._buf.extend(self._chunks.pop(0))
        out = bytes(self._buf[:n])
        del self._buf[: len(out)]
        return out

    async def readexactly(self, n):
        while len(self._buf) < n and self._chunks:
            self._buf.extend(self._chunks.pop(0))
        if len(self._buf) < n:
            raise asyncio.IncompleteReadError(bytes(self._buf), n)
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out


def _sources(pkg):
    bus, codec = mod(pkg, "net.bus"), mod(pkg, "net.codec")
    out = {"python": lambda r: bus.PythonFrameSource(r)}
    if codec.enabled():
        out["native"] = lambda r: bus.NativeFrameSource(r, codec.scanner())
    return out


async def _drain(source):
    out = []
    while True:
        batch = await source.next_batch()
        if batch is None:
            return out
        out.extend(bytes(m.to_bytes()) for m in batch)


def test_frame_sources_split_at_every_offset():
    frames = _frames(np.random.default_rng(41))
    stream = b"".join(frames)
    ref, port = _sources(REFERENCE), _sources(PORT)
    assert set(port) == set(ref)

    async def run():
        for k in range(len(stream) + 1):
            chunks = [stream[:k], stream[k:]]
            for name in ref:
                want = await _drain(ref[name](_Reader(chunks)))
                assert want == frames, (name, k)
                assert await _drain(port[name](_Reader(chunks))) == want, (name, k)

    asyncio.run(run())


@pytest.mark.parametrize("where", ["header", "body"])
def test_corrupt_frame_ends_the_stream_alike(where):
    frames = _frames(np.random.default_rng(42))
    bad = bytearray(frames[2])
    bad[20 if where == "header" else -1] ^= 0xA5
    if where == "body" and len(bad) == 256:
        bad[20] ^= 0xA5  # a frame without a body: flip its header
    stream = b"".join(frames[:2]) + bytes(bad) + b"".join(frames[3:])
    counts = {}
    for pkg in (REFERENCE, PORT):
        tracer = mod(pkg, "tracer")
        for name, make in _sources(pkg).items():
            tracer.reset()
            tracer.enable()
            try:
                got = asyncio.run(_drain(make(_Reader([stream[:300], stream[300:]]))))
                counts[(pkg, name)] = (got, tracer.snapshot()["bus.rx_checksum_fail"]["count"])
            finally:
                tracer.disable()
                tracer.reset()
    for key, (got, fails) in counts.items():
        assert got == frames[:2] and fails == 1, key


SPECS = ["drop=0.1,dup=0.1,corrupt=0.1,seed=7",
         "drop=0.02,delay_ms=2,delay_to=1|2,blackhole=2,seed=3",
         "corrupt=0.5"]


@pytest.mark.parametrize("spec", SPECS)
def test_net_fault_parses_alike(spec):
    a = mod(REFERENCE, "net.bus").NetFault(spec)
    b = mod(PORT, "net.bus").NetFault(spec)
    for k in ("drop", "dup", "corrupt", "delay_s", "delay_to", "blackhole"):
        assert getattr(a, k) == getattr(b, k), k
    assert a.rng.random() == b.rng.random()
    for pkg in (REFERENCE, PORT):
        with pytest.raises(ValueError):
            mod(pkg, "net.bus").NetFault(spec + ",typo=1")


class _Conn:
    def __init__(self):
        self.sent = []

    def send(self, data, command=None):
        self.sent.append(("raw", bytes(data), command))

    def send_message(self, msg):
        self.sent.append(("msg", bytes(msg.to_bytes()), None))


def _fault_schedule(pkg, spec, seed, messages):
    bus = mod(pkg, "net.bus")
    server = bus.ReplicaServer(SimpleNamespace(replica=0, bus=None),
                               [("127.0.0.1", 1), ("127.0.0.1", 2), ("127.0.0.1", 3)])
    server.net_fault = bus.NetFault(spec, seed=seed)
    conns = {1: _Conn(), 2: _Conn()}
    for i, m in enumerate(messages):
        r = 1 + i % 2
        server._send_faulted(r, conns[r], mod(pkg, "vsr.header").Message.from_bytes(bytearray(m)))
    return conns[1].sent, conns[2].sent


@pytest.mark.parametrize("spec", SPECS)
def test_net_fault_schedule_matches_reference(spec):
    messages = _frames(np.random.default_rng(43), n=300)
    want = _fault_schedule(REFERENCE, spec, 11, messages)
    got = _fault_schedule(PORT, spec, 11, messages)
    assert got == want
    assert sum(len(x) for x in got) != len(messages) or "corrupt=0.5" in spec


def test_three_replicas_over_tcp_replicate_and_converge(tmp_path):
    ports = [free_port() for _ in range(3)]
    addrs = [("127.0.0.1", p) for p in ports]
    servers = [ServerThread(PORT, str(tmp_path / f"r{i}.tb"), addrs, index=i)
               for i in range(3)]
    try:
        client = mod(PORT, "client").Client(addrs)
        assert len(client.create_accounts(account_records(PORT, range(1, 21)))) == 0
        rng = np.random.default_rng(9)
        for b in range(3):
            client.create_transfers(transfer_records(PORT, seeded_transfers(rng, 50 + 60 * b, 60, 20)))
        looked = client.lookup_accounts(list(range(1, 21)))
        client.close()
        assert len(looked) == 20
        target = max(s.replica.commit_min for s in servers)
        deadline = time.monotonic() + 30
        while min(s.replica.commit_min for s in servers) < target:
            assert time.monotonic() < deadline, [s.replica.commit_min for s in servers]
            time.sleep(0.05)
        chains = [dict(s.replica.commit_checksums) for s in servers]
        assert target >= 5
        for op in range(2, target + 1):
            assert len({c.get(op) for c in chains}) == 1, op
    finally:
        for s in servers:
            s.stop()
