"""The port's AOF (vsr/aof.py) against the reference package's.

The same sealed prepares written through both packages' `AOF` give the
same file bytes; `iter_entries` and `merge` read the same entries from
the same files, torn and corrupt ones included; and one AOF, written by
the port's replica serving TCP on the wall clock, replays through both
packages' `recover` (the reference on its numpy backend, the port with
`device="cpu"`) to byte-equal accounts and transfers, timestamps
included, equal to what the live replica holds.
"""

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


def _prepare(pkg, op, body=b"", view=1, parent=0, operation=None):
    hdr = mod(pkg, "vsr.header")
    operation = hdr.Operation.CREATE_ACCOUNTS if operation is None else operation
    h = hdr.make(hdr.Command.PREPARE, 0, view=view, op=op, timestamp=op,
                 operation=operation, parent=parent)
    return hdr.Message(h, body).seal()


def _write(pkg, path, msgs, replica=0):
    w = mod(pkg, "vsr.aof").AOF(path)
    for m in msgs:
        w.append(mod(pkg, "vsr.header").Message.from_bytes(bytearray(m)), primary=1,
                 replica=replica)
    w.sync()
    w.close()


def _entries(pkg, path):
    return [(m.to_bytes(), p, r) for m, p, r in mod(pkg, "vsr.aof").iter_entries(path)]


def _ref_prepares(n, size=100):
    return [_prepare(REFERENCE, op, bytes([op]) * (size + op)).to_bytes()
            for op in range(1, n + 1)]


def test_file_bytes_equal(tmp_path):
    msgs = _ref_prepares(9)
    _write(REFERENCE, str(tmp_path / "ref.aof"), msgs, replica=2)
    _write(PORT, str(tmp_path / "port.aof"), msgs, replica=2)
    a = (tmp_path / "ref.aof").read_bytes()
    assert len(a) > 9 * 100 and a == (tmp_path / "port.aof").read_bytes()


def test_reopen_skips_recorded_ops_like_the_reference(tmp_path):
    msgs = _ref_prepares(8)
    for pkg in (REFERENCE, PORT):
        path = str(tmp_path / f"{pkg}.aof")
        _write(pkg, path, msgs[:5])
        _write(pkg, path, msgs[2:])  # a restart re-offers ops 3-5
    assert (tmp_path / f"{REFERENCE}.aof").read_bytes() == (tmp_path / f"{PORT}.aof").read_bytes()
    assert [m for m, _, _ in _entries(PORT, str(tmp_path / f"{PORT}.aof"))] == msgs


@pytest.mark.parametrize("cut", ["corrupt_middle", "torn_tail", "garbage_prefix"])
def test_iter_entries_matches_reference(tmp_path, cut):
    path = str(tmp_path / "a.aof")
    _write(REFERENCE, path, _ref_prepares(7))
    data = bytearray(open(path, "rb").read())
    span = len(data) // 7
    if cut == "corrupt_middle":
        data[2 * span + 80] ^= 0xFF
    elif cut == "torn_tail":
        data = data[: len(data) - span // 2]
    else:
        data = bytearray(b"\x5a" * 77) + data
    open(path, "wb").write(data)
    want = _entries(REFERENCE, path)
    assert 0 < len(want) <= 7
    assert _entries(PORT, path) == want


def test_merge_matches_reference(tmp_path):
    """Three replicas' files: overlapping ranges, a gap in one, and a
    divergent never-committed suffix whose parent chain breaks."""
    chain = []
    parent = 0
    for op in range(1, 11):
        m = _prepare(REFERENCE, op, bytes([op]) * 64, parent=parent)
        parent = m.header["checksum"]
        chain.append(m.to_bytes())
    stray = _prepare(REFERENCE, 9, b"\x77" * 64, view=2, parent=12345).to_bytes()
    paths = [str(tmp_path / f"r{i}.aof") for i in range(3)]
    _write(REFERENCE, paths[0], chain[:6], replica=0)
    _write(REFERENCE, paths[1], chain[2:4] + chain[5:], replica=1)
    _write(REFERENCE, paths[2], chain[:8] + [stray], replica=2)
    want = [m.to_bytes() for m in mod(REFERENCE, "vsr.aof").merge(paths)]
    got = [m.to_bytes() for m in mod(PORT, "vsr.aof").merge(paths)]
    assert got == want == chain


def _serve_with_aof(pkg, tmp_path, frozen):
    """A stream of creates through `pkg`'s replica serving TCP with its
    AOF on; returns (aof path, create replies, account and transfer
    lookups of the live replica)."""
    port = free_port()
    path = str(tmp_path / f"{pkg}-{frozen}.tb")
    s = ServerThread(pkg, path, [("127.0.0.1", port)], aof=True, frozen=frozen)
    # One client id for every run: it rides in each prepare's header.
    client = mod(PORT, "client").Client([("127.0.0.1", port)], client_id=0xC11E)
    rng = np.random.default_rng(7)
    replies = []
    try:
        replies.append(client.create_accounts(account_records(PORT, range(1, 31))))
        for b in range(4):
            specs = seeded_transfers(rng, 100 + 60 * b, 60, 30)
            replies.append(client.create_transfers(transfer_records(PORT, specs)))
        accounts = client.lookup_accounts(list(range(1, 32)))
        # TEST_MIN's batch_max is 64 events: look the ids up 60 at a time.
        transfers = np.concatenate([client.lookup_transfers(list(range(k, k + 60)))
                                    for k in range(100, 340, 60)])
    finally:
        client.close()
        s.stop()
    return path + ".aof", replies, accounts, transfers


def _recovered(pkg, aof_path):
    sm_kw = dict(backend="numpy") if pkg == REFERENCE else dict(device="cpu")
    config = mod(pkg, "constants").TEST_MIN
    sm, last_op = mod(pkg, "vsr.aof").recover([aof_path], config=config, **sm_kw)
    ids = np.arange(1, 340, dtype=np.uint64)
    zeros = np.zeros_like(ids)
    return (sm.lookup_accounts(ids[:31], zeros[:31]).tobytes(),
            sm.lookup_transfers(ids, zeros).tobytes(), last_op)


def test_recover_is_byte_equal_across_packages(tmp_path):
    aof, replies, accounts, transfers = _serve_with_aof(PORT, tmp_path, frozen=False)
    ref = _recovered(REFERENCE, aof)
    port = _recovered(PORT, aof)
    assert ref == port
    assert port[2] >= 6  # register + 5 creates
    # ... and equal to the live replica's state, its clock's timestamps
    # included: the replay runs each prepare at its own timestamp.
    assert port[0] == accounts.tobytes() and len(accounts) == 30
    assert port[1] == transfers.tobytes() and len(transfers) > 100


def test_recover_result_codes_equal_the_live_replies(tmp_path):
    aof, replies, _a, _t = _serve_with_aof(PORT, tmp_path, frozen=False)
    codes = []
    mod(PORT, "vsr.aof").recover([aof], config=mod(PORT, "constants").TEST_MIN,
                                 device="cpu", on_result=lambda h, r: codes.append(r.tobytes()))
    assert codes == [r.tobytes() for r in replies]
    assert any(len(r) for r in replies)


def test_frozen_servers_write_equal_aofs(tmp_path):
    """On frozen time both packages' replicas commit the same prepares:
    their AOF files are byte-equal."""
    ref = _serve_with_aof(REFERENCE, tmp_path, frozen=True)
    port = _serve_with_aof(PORT, tmp_path, frozen=True)
    assert open(ref[0], "rb").read() == open(port[0], "rb").read()
    assert [r.tobytes() for r in ref[1]] == [r.tobytes() for r in port[1]]
