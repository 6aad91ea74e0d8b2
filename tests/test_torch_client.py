"""The port's clients and server against the reference package's, over TCP.

Each package's `Client` drives each package's `ReplicaServer` (the
reference on its numpy backend, the port with `device="cpu"`) through
one seeded stream of creates, lookups and queries: every pair returns
the same result codes, and lookups equal apart from the fields the
replica's clock sets. With the replicas' time frozen the two servers'
replies are byte-equal. The `AsyncClient`'s coalescing and demux equal
the reference's on seeded batches, and the C client drives the port's
server.
"""

import asyncio
import ctypes

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
    without_clock,
)

N_ACCOUNTS = 40


def _stream(server_pkg, client_pkg, tmp_path, frozen=False):
    """Run the request stream of `client_pkg`'s Client against a fresh
    `server_pkg` server; returns every reply body in order."""
    port = free_port()
    s = ServerThread(server_pkg, str(tmp_path / f"{server_pkg}-{client_pkg}.tb"),
                     [("127.0.0.1", port)], frozen=frozen)
    client = mod(client_pkg, "client").Client([("127.0.0.1", port)])
    rng = np.random.default_rng(14)
    out = []
    try:
        ids = list(range(1, N_ACCOUNTS + 1)) + [3]  # one id twice: exists
        out.append(client.create_accounts(account_records(client_pkg, ids)).tobytes())
        for b in range(3):
            specs = seeded_transfers(rng, 1000 + 64 * b, 60, N_ACCOUNTS)
            out.append(client.create_transfers(transfer_records(client_pkg, specs)).tobytes())
        out.append(client.lookup_accounts(list(range(1, N_ACCOUNTS + 3))).tobytes())
        out.append(client.lookup_transfers(list(range(1000, 1000 + 64 * 3, 5))).tobytes())
        out.append(client.get_account_transfers(7).tobytes())
        out.append(client.query_transfers(code=2, limit=50).tobytes())
        out.append(client.query_transfers(debit_account_id=5, code=1).tobytes())
        out.append(client.query_accounts(ledger=1, code=10, limit=16).tobytes())
    finally:
        client.close()
        s.stop()
    return out


def _dtypes(types):
    e, a, t = types.EVENT_RESULT_DTYPE, types.ACCOUNT_DTYPE, types.TRANSFER_DTYPE
    return [e, e, e, e, a, t, t, t, t, a]


def test_every_client_server_pair_answers_alike(tmp_path):
    types = mod(PORT, "types")
    runs = {(srv, cli): _stream(srv, cli, tmp_path)
            for srv in (REFERENCE, PORT) for cli in (REFERENCE, PORT)}
    want = runs[(REFERENCE, REFERENCE)]
    results = np.frombuffer(bytearray(want[0] + want[1]), dtype=types.EVENT_RESULT_DTYPE)
    assert len(results) > 2  # the stream has failing events
    assert len(np.frombuffer(bytearray(want[4]), dtype=types.ACCOUNT_DTYPE)) == N_ACCOUNTS
    for pair, got in runs.items():
        assert len(got) == len(want), pair
        for k, (dt, a, b) in enumerate(zip(_dtypes(types), got, want)):
            ra, rb = np.frombuffer(bytearray(a), dt), np.frombuffer(bytearray(b), dt)
            if "timestamp" in dt.names:
                assert without_clock(ra) == without_clock(rb), (pair, k)
            else:  # result codes
                assert a == b, (pair, k)


def test_frozen_servers_reply_byte_equal(tmp_path):
    """On frozen time the prepare timestamps follow the op stream alone:
    the reference's server and the port's give byte-equal replies."""
    ref = _stream(REFERENCE, PORT, tmp_path, frozen=True)
    port = _stream(PORT, PORT, tmp_path, frozen=True)
    assert ref == port


def _batches(types, rng):
    """Seeded logical batches for the coalescing plan: varied sizes, some
    ending in an open linked chain."""
    out = []
    for k in range(24):
        n = int(rng.integers(1, 40))
        ev = np.zeros(n, dtype=types.TRANSFER_DTYPE)
        ev["id_lo"] = np.arange(100 * k + 1, 100 * k + 1 + n, dtype=np.uint64)
        ev["flags"] = np.where(rng.random(n) < 0.2, 1, 0).astype(ev["flags"].dtype)
        out.append(ev)
    return out


@pytest.mark.parametrize("batch_max", [40, 64, 8190])
def test_plan_coalesce_matches_reference(batch_max):
    rng = np.random.default_rng(batch_max)
    batches = _batches(mod(PORT, "types"), rng)
    want = mod(REFERENCE, "client").AsyncClient.plan_coalesce(batches, batch_max=batch_max)
    got = mod(PORT, "client").AsyncClient.plan_coalesce(batches, batch_max=batch_max)
    assert got == want and len(got) > 1


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_demux_results_matches_reference(seed):
    types = mod(PORT, "types")
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(0, 30, 9)]
    total = sum(lens)
    idx = np.sort(rng.choice(total, size=total // 3, replace=False)).astype(np.uint32)
    res = np.zeros(len(idx), dtype=types.EVENT_RESULT_DTYPE)
    res["index"] = idx
    res["result"] = rng.integers(1, 60, len(idx))
    want = mod(REFERENCE, "client").AsyncClient.demux_results(res, lens)
    got = mod(PORT, "client").AsyncClient.demux_results(res, lens)
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
    bad = res.copy()
    bad["index"][-1] = total  # out of range: both raise
    for pkg in (REFERENCE, PORT):
        with pytest.raises(mod(pkg, "client").ClientError):
            mod(pkg, "client").AsyncClient.demux_results(bad, lens)


def test_async_client_submit_many_against_the_port(tmp_path):
    """Coalesced logical batches through the port's AsyncClient give
    per-batch results byte-equal to the same batches sent one request at
    a time by the sync client to a twin server."""
    types = mod(PORT, "types")
    ac_mod = mod(PORT, "client")
    rng = np.random.default_rng(5)
    specs = seeded_transfers(rng, 5000, 48, N_ACCOUNTS)
    batches = [transfer_records(PORT, specs[i:i + 12]) for i in range(0, 48, 12)]
    acc = account_records(PORT, range(1, N_ACCOUNTS + 1))
    ports = [free_port(), free_port()]
    servers = [ServerThread(PORT, str(tmp_path / f"s{i}.tb"), [("127.0.0.1", p)])
               for i, p in enumerate(ports)]
    try:
        one = ac_mod.Client([("127.0.0.1", ports[0])])
        assert len(one.create_accounts(acc)) == 0
        want = [one.create_transfers(b).tobytes() for b in batches]
        one.close()

        async def run():
            async with ac_mod.AsyncClient([("127.0.0.1", ports[1])], sessions=2) as ac:
                assert len(await ac.create_accounts(acc)) == 0
                return await ac.submit_many(mod(PORT, "vsr.header").Operation.CREATE_TRANSFERS,
                                            batches)

        got = asyncio.run(run())
        assert [g.tobytes() for g in got] == want
        assert any(len(np.frombuffer(bytearray(w), types.EVENT_RESULT_DTYPE)) for w in want)
    finally:
        for s in servers:
            s.stop()


def _u8(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def test_c_client_against_the_port(tmp_path):
    lib = mod(PORT, "native").tb_client()
    if lib is None:
        pytest.skip("the C client needs AES-NI and a C compiler")
    types = mod(PORT, "types")
    port = free_port()
    server = ServerThread(PORT, str(tmp_path / "c.tb"), [("127.0.0.1", port)])
    try:
        h = lib.tbc_connect(b"127.0.0.1", port, 0, 4000)
        assert h, "tbc_connect (incl. session register) failed"
        try:
            accs = account_records(PORT, (1, 2))
            res = np.zeros(16, dtype=types.EVENT_RESULT_DTYPE)
            assert lib.tbc_create_accounts(h, _u8(accs), 2, _u8(res.view(np.uint8)), 16) == 0
            ts = transfer_records(PORT, [
                dict(id=1, debit_account_id=1, credit_account_id=2, amount=500, ledger=1, code=1),
                dict(id=2, debit_account_id=2, credit_account_id=1, amount=200, ledger=1, code=1),
            ])
            assert lib.tbc_create_transfers(h, _u8(ts), 2, _u8(res.view(np.uint8)), 16) == 0
            assert lib.tbc_create_transfers(h, _u8(ts), 2, _u8(res.view(np.uint8)), 16) == 2
            assert [int(r["result"]) for r in res[:2]] == [46, 46]  # exists
            ids = np.zeros(2, dtype=types.ID_DTYPE)
            ids["lo"] = [1, 2]
            out = np.zeros(4, dtype=types.ACCOUNT_DTYPE)
            assert lib.tbc_lookup_accounts(h, _u8(ids.view(np.uint8)), 2,
                                           _u8(out.view(np.uint8)), 4) == 2
            assert types.u128_of(out[0], "debits_posted") == 500
            assert types.u128_of(out[1], "credits_posted") == 500
            tout = np.zeros(4, dtype=types.TRANSFER_DTYPE)
            assert lib.tbc_lookup_transfers(h, _u8(ids.view(np.uint8)), 2,
                                            _u8(tout.view(np.uint8)), 4) == 2
            assert types.u128_of(tout[1], "amount") == 200
        finally:
            lib.tbc_close(h)
    finally:
        server.stop()
