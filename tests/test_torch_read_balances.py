"""The balance read's caller (the port's StateMachine._read_balances) on
the CPU against the reference package's StateMachine(backend="jax").

Every lookup and the serial route's preload read balances through
`_read_balances`: one copy of the padded slots in, one launch, the (4,
bucket, 4) block back in one copy. Here the machine runs the plain
versions. `lookup_accounts` of k accounts and a serial batch whose
preload reads k accounts must give the reference's bytes at k = 1, 16
(a whole bucket), 17 (a bucket with padding) and 8190 (a full batch's
lookup), on one device and on a mesh (dp 2 x shard 4 of CPU devices);
and the arrays two successive reads return must not share memory.
"""

import numpy as np
import pytest
import torch

from tigerbeetle_tpu import types
from tigerbeetle_tpu.constants import Config
from tigerbeetle_tpu.models.state_machine import StateMachine as RefSM
from tigerbeetle_tpu_torch.models.state_machine import StateMachine as PortSM
from tigerbeetle_tpu_torch.parallel import sharding as S

N_ACCOUNTS = 8191
CFG = Config(name="unit", accounts_max=1 << 14, transfers_max=1 << 15, batch_max=8190)
KS = [1, 16, 17, 8190]


def _accounts():
    return types.batch(
        [types.account(id=i + 1, ledger=1, code=10) for i in range(N_ACCOUNTS)],
        types.ACCOUNT_DTYPE,
    )


def _funding(n):
    """One transfer onto each of n accounts (ids 1..n) from the last one,
    so that every balance the reads return differs."""
    return types.batch(
        [types.transfer(id=10 ** 6 + i, debit_account_id=N_ACCOUNTS, credit_account_id=i + 1,
                        amount=1000 + i, ledger=1, code=7, flags=2 * (i % 3 == 0),
                        timeout=5 * (i % 3 == 0))
         for i in range(n)],
        types.TRANSFER_DTYPE,
    )


def _serial(k, first_id):
    """A batch that takes the serial route (its last transfer repeats its
    first one's id) and touches exactly accounts 1..k."""
    ids = np.arange(1, k + 1)
    pairs = [(int(ids[2 * i]), int(ids[(2 * i + 1) % k])) for i in range((k + 1) // 2)]
    recs = [types.transfer(id=first_id + i, debit_account_id=dr, credit_account_id=cr,
                           amount=1 + i, ledger=1, code=7)
            for i, (dr, cr) in enumerate(pairs)]
    recs.append(recs[0])
    return types.batch(recs, types.TRANSFER_DTYPE)


@pytest.fixture(scope="module")
def machines():
    ref = RefSM(CFG, backend="jax")
    ports = {"single": PortSM(CFG, device="cpu"),
             "mesh": PortSM(CFG, device="cpu", mesh=S.make_mesh([torch.device("cpu")] * 8))}
    for op, batch in (("create_accounts", _accounts()), ("create_transfers", _funding(N_ACCOUNTS - 1))):
        want = getattr(ref, op)(batch.copy())
        for port in ports.values():
            assert getattr(port, op)(batch.copy()).tobytes() == want.tobytes()
    return ref, ports


def _recorded(port):
    """Wrap the machine's _read_balances to record each call's k."""
    ks = []
    inner = port._read_balances

    def read(slots):
        ks.append(len(np.atleast_1d(slots)))
        return inner(slots)

    port._read_balances = read
    return ks, inner


@pytest.mark.parametrize("route", ["single", "mesh"])
@pytest.mark.parametrize("k", KS)
def test_lookup_accounts_matches_reference(machines, route, k):
    ref, ports = machines
    port = ports[route]
    ids = np.arange(N_ACCOUNTS - k + 1, N_ACCOUNTS + 1, dtype=np.uint64)[::-1].copy()
    zero = np.zeros(k, np.uint64)
    ks, inner = _recorded(port)
    try:
        got = port.lookup_accounts(ids, zero)
    finally:
        port._read_balances = inner
    assert ks == [k]
    assert got.tobytes() == ref.lookup_accounts(ids, zero).tobytes()


@pytest.mark.parametrize("k", KS)
def test_serial_preload_matches_reference(machines, k):
    """The serial route's preload reads k accounts in one call; the
    results and every touched account equal the reference's. Both routes
    see the same batch, so the machines stay equal for the next case."""
    ref, ports = machines
    batch = _serial(k, 2 * 10 ** 6 + 10_000 * k)
    want = ref.create_transfers(batch.copy())
    for port in ports.values():
        before = port.stats["serial_batches"]
        ks, inner = _recorded(port)
        try:
            got = port.create_transfers(batch.copy())
        finally:
            port._read_balances = inner
        assert port.stats["serial_batches"] == before + 1
        assert k in ks
        assert got.tobytes() == want.tobytes()
        ids = np.arange(1, k + 1, dtype=np.uint64)
        zero = np.zeros(k, np.uint64)
        assert port.lookup_accounts(ids, zero).tobytes() == ref.lookup_accounts(ids, zero).tobytes()


@pytest.mark.parametrize("route", ["single", "mesh"])
def test_reads_do_not_share_memory(machines, route):
    """Two successive reads of one bucket size: the second reuses the
    host buffers, and must leave the first's arrays as they were."""
    port = machines[1][route]
    first = port._read_balances(np.arange(100, 117))
    kept = [a.copy() for a in first]
    second = port._read_balances(np.arange(3000, 3017))
    for a, want in zip(first, kept):
        assert np.array_equal(a, want)
        assert a.shape == (17, 4) and a.dtype == np.uint32
        assert not any(np.shares_memory(a, b) for b in second)
    assert not np.array_equal(np.stack(first), np.stack(second))
