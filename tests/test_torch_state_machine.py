"""The port's StateMachine (device="cpu") against the reference package's
StateMachine(backend="jax") on the same op streams.

Both machines see the same batches, made with numpy from a seed. Result
arrays, `lookup_accounts` bytes of every account and `lookup_transfers`
bytes of every transfer must be equal (exact: integer state). The port
runs its kernels' plain PyTorch versions here; chip_smoke.py runs the same
machine on CUDA against this CPU run.
"""

import numpy as np
import pytest

from tigerbeetle_tpu import types
from tigerbeetle_tpu.constants import Config
from tigerbeetle_tpu.flags import TransferFlags
from tigerbeetle_tpu.models.state_machine import StateMachine as RefSM
from tigerbeetle_tpu_torch.models.state_machine import StateMachine as PortSM

CFG = Config(name="unit", accounts_max=1 << 12, transfers_max=1 << 14, batch_max=64)
N_ACCOUNTS = 48
U128_MAX = (1 << 128) - 1


def _accounts(rng):
    return types.batch(
        [
            types.account(id=i + 1, ledger=1 + (i % 8 == 7), code=10)
            for i in range(N_ACCOUNTS)
        ],
        types.ACCOUNT_DTYPE,
    )


def _transfers(rng, start_id, n, *, dup=False, linked=False, huge=False):
    """n transfers over the accounts (a few ids beyond them: not found),
    a quarter pending. dup repeats ids in the batch; linked sets a linked
    chain; huge posts amounts near 2^128 onto two hot accounts."""
    recs = []
    for i in range(n):
        flags = int(TransferFlags.PENDING) if rng.random() < 0.25 else 0
        dr, cr = (int(x) for x in rng.integers(1, N_ACCOUNTS + 3, 2))
        amount = int(rng.integers(1, 1 << 40))
        if huge:
            dr, cr, amount = 1, 2, U128_MAX - int(rng.integers(0, 1 << 20))
        recs.append(types.transfer(
            id=start_id + i, debit_account_id=dr, credit_account_id=cr,
            amount=amount, ledger=1, code=7, flags=flags,
            timeout=5 if flags else 0,
        ))
    if dup:
        recs[-1] = recs[0]
    if linked:
        recs[1]["flags"] |= TransferFlags.LINKED
    return types.batch(recs, types.TRANSFER_DTYPE)


def _pair():
    return RefSM(CFG, backend="jax"), PortSM(CFG, device="cpu")


def _check_same(ref, port, max_id):
    ids = np.arange(1, N_ACCOUNTS + 1, dtype=np.uint64)
    zero = np.zeros(len(ids), dtype=np.uint64)
    want = ref.lookup_accounts(ids, zero)
    assert len(want) == N_ACCOUNTS
    assert port.lookup_accounts(ids, zero).tobytes() == want.tobytes()
    tids = np.arange(1, max_id, dtype=np.uint64)
    tzero = np.zeros(len(tids), dtype=np.uint64)
    assert port.lookup_transfers(tids, tzero).tobytes() == ref.lookup_transfers(tids, tzero).tobytes()
    assert port.commit_timestamp == ref.commit_timestamp


def _both(ref, port, op, batch):
    want = getattr(ref, op)(batch.copy())
    got = getattr(port, op)(batch.copy())
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
    return got


@pytest.mark.parametrize("stream", ["simple", "serial", "bail"])
def test_stream_matches_reference(stream):
    rng = np.random.default_rng({"simple": 1, "serial": 2, "bail": 3}[stream])
    ref, port = _pair()
    _both(ref, port, "create_accounts", _accounts(rng))
    next_id = 1000
    for k in range(4):
        kw = {}
        if stream == "serial":
            kw = {"dup": k % 2 == 0, "linked": k % 2 == 1}
        if stream == "bail" and k == 2:
            kw = {"huge": True}
        _both(ref, port, "create_transfers", _transfers(rng, next_id, 64, **kw))
        next_id += 64
    _check_same(ref, port, next_id)
    if stream == "simple":
        assert port.stats["fast_batches"] == 4
    if stream == "serial":
        assert port.stats["serial_batches"] == 2  # the duplicate-id batches
        assert port.stats["exact_batches"] == 2  # the linked batches
        for k in ("serial_batches", "exact_batches", "bail_batches"):
            assert port.stats[k] == ref.stats[k], k
    if stream == "bail":
        assert port.stats["bail_batches"] >= 1
        assert port.stats["fast_batches"] >= 1


def test_split_phase_window_matches_reference():
    """A depth-2 dispatch/finish window, then a depth-2 window abandoned
    and re-run single-phase, on both machines."""
    rng = np.random.default_rng(4)
    ref, port = _pair()
    _both(ref, port, "create_accounts", _accounts(rng))
    a = _transfers(rng, 1000, 64)
    b = _transfers(rng, 2000, 64)
    ts_a = ref.prepare("create_transfers", len(a))
    assert port.prepare("create_transfers", len(a)) == ts_a
    ts_b = ref.prepare("create_transfers", len(b))
    assert port.prepare("create_transfers", len(b)) == ts_b
    handles = []
    for sm in (ref, port):
        ha = sm.create_transfers_dispatch(a.copy(), ts_a)
        hb = sm.create_transfers_dispatch(b.copy(), ts_b)
        assert ha is not None and hb is not None
        handles.append((ha, hb))
    for i in range(2):
        want = ref.create_transfers_finish(handles[0][i])
        got = port.create_transfers_finish(handles[1][i])
        assert got.tobytes() == want.tobytes()
    _check_same(ref, port, 2100)

    # Abandoned window: the state rolls back to before both dispatches.
    c = _transfers(rng, 3000, 64)
    d = _transfers(rng, 4000, 64)
    before = port.lookup_accounts(
        np.arange(1, N_ACCOUNTS + 1, dtype=np.uint64), np.zeros(N_ACCOUNTS, np.uint64)
    )
    for sm in (ref, port):
        ts_c = sm.prepare("create_transfers", len(c))
        ts_d = sm.prepare("create_transfers", len(d))
        assert sm.create_transfers_dispatch(c.copy(), ts_c) is not None
        assert sm.create_transfers_dispatch(d.copy(), ts_d) is not None
        sm.create_transfers_abandon_all()
    after = port.lookup_accounts(
        np.arange(1, N_ACCOUNTS + 1, dtype=np.uint64), np.zeros(N_ACCOUNTS, np.uint64)
    )
    assert after.tobytes() == before.tobytes()
    _both(ref, port, "create_transfers", c)
    _both(ref, port, "create_transfers", d)
    _check_same(ref, port, 4100)
    assert port.dispatch_depth_default() == 1  # CPU: no dispatch-ahead


def test_bail_in_window_rolls_back_like_reference():
    """A dispatched batch that bails rolls the state back and re-runs
    serially; the batch chained behind it re-runs from the corrected
    state (gen fencing)."""
    rng = np.random.default_rng(5)
    ref, port = _pair()
    _both(ref, port, "create_accounts", _accounts(rng))
    a = _transfers(rng, 1000, 64, huge=True)
    b = _transfers(rng, 2000, 64)
    for sm in (ref, port):
        ts_a = sm.prepare("create_transfers", len(a))
        ts_b = sm.prepare("create_transfers", len(b))
        sm._h = (sm.create_transfers_dispatch(a.copy(), ts_a),
                 sm.create_transfers_dispatch(b.copy(), ts_b))
    for i in range(2):
        assert port.create_transfers_finish(port._h[i]).tobytes() == \
            ref.create_transfers_finish(ref._h[i]).tobytes()
    _check_same(ref, port, 2100)
    assert port.stats["bail_batches"] == ref.stats["bail_batches"] >= 1


@pytest.mark.parametrize("after", ["finish", "abandon"])
def test_bail_writeback_keeps_later_bases(after):
    """A bail's serial writeback lands in place in the rolled-back tables.
    Batches dispatched before it re-run from the corrected state; a batch
    dispatched after it keeps its own base, which abandon_all restores."""
    rng = np.random.default_rng(8)
    ref, port = _pair()
    _both(ref, port, "create_accounts", _accounts(rng))
    a = _transfers(rng, 1000, 64, huge=True)
    b = _transfers(rng, 2000, 64)
    c = _transfers(rng, 3000, 64)
    out = {}
    for sm in (ref, port):
        ts = [sm.prepare("create_transfers", 64) for _ in range(3)]
        ha = sm.create_transfers_dispatch(a.copy(), ts[0])
        hb = sm.create_transfers_dispatch(b.copy(), ts[1])
        res = [sm.create_transfers_finish(ha)]  # bails: serial writeback
        hc = sm.create_transfers_dispatch(c.copy(), ts[2])
        assert None not in (ha, hb, hc)
        if after == "finish":
            res += [sm.create_transfers_finish(hb), sm.create_transfers_finish(hc)]
        else:
            sm.create_transfers_abandon_all()
            res += [sm.create_transfers(b.copy(), ts[1]),
                    sm.create_transfers(c.copy(), ts[2])]
        out[sm] = [r.tobytes() for r in res]
    assert out[port] == out[ref]
    _check_same(ref, port, 3100)
    for k, v in port.stats.items():
        assert v == ref.stats[k], k
    assert port.stats["bail_batches"] >= 1


def test_tracer_records_the_kernel_entries():
    """With the tracer on, each kernel entry the path ran shows up as a
    device span and in the call-shape registry (CPU: host-clock windows)."""
    from tigerbeetle_tpu_torch import devicestats, tracer

    tracer.enable()
    tracer.reset()
    try:
        rng = np.random.default_rng(6)
        port = PortSM(CFG, device="cpu")
        port.create_accounts(_accounts(rng))
        port.create_transfers(_transfers(rng, 1000, 64))
        port.create_transfers(_transfers(rng, 2000, 64, huge=True))  # bail
        snap = tracer.snapshot()
        shapes = devicestats.observed_shapes()
    finally:
        tracer.disable()
        tracer.reset()
    assert snap["device.step.create_transfers_fast"]["count"] == 2
    for entry in ("register_accounts", "read_balances", "write_balances"):
        assert snap[f"device.{entry}"]["count"] >= 1, entry
        assert shapes[entry], entry
    assert snap["device.create_transfers_fast.dispatches"]["count"] == 2


def test_block_checksum_matches_reference():
    """Grid blocks are sealed with the same checksum in both packages."""
    from tigerbeetle_tpu.vsr import header as ref_header
    from tigerbeetle_tpu_torch.vsr import header as port_header

    data = np.random.default_rng(7).integers(0, 256, 4096, dtype=np.uint8)
    assert port_header.checksum(data) == ref_header.checksum(data)
    assert port_header.checksum(b"tigerbeetle") == ref_header.checksum(b"tigerbeetle")
    assert port_header.CHECKSUM_ALGORITHM == ref_header.CHECKSUM_ALGORITHM


# --- the exact route: scenarios of tests/test_state_machine.py ------------

L = int(TransferFlags.LINKED)
P = int(TransferFlags.PENDING)
POST = int(TransferFlags.POST_PENDING_TRANSFER)
VOID = int(TransferFlags.VOID_PENDING_TRANSFER)
BAL_DR = int(TransferFlags.BALANCING_DEBIT)
BAL_CR = int(TransferFlags.BALANCING_CREDIT)


def _t(id, dr=0, cr=0, amount=0, flags=0, **kw):
    kw.setdefault("ledger", 1)
    kw.setdefault("code", 1)
    return types.transfer(id=id, debit_account_id=dr, credit_account_id=cr,
                          amount=amount, flags=flags, **kw)


def _accs(*flags):
    """Accounts 1..len(flags) on ledger 1 with the given account flags."""
    return types.batch([types.account(id=i + 1, ledger=1, code=1, flags=f)
                        for i, f in enumerate(flags)], types.ACCOUNT_DTYPE)


def _tb(*recs):
    return types.batch(list(recs), types.TRANSFER_DTYPE)


def _random_limits(seed):
    """Config-4-shaped batches: balancing flags and limit accounts."""
    from tigerbeetle_tpu.flags import AccountFlags as AF

    rng = np.random.default_rng(1000 + seed)
    flags = [int(rng.choice([0, 0, AF.DEBITS_MUST_NOT_EXCEED_CREDITS,
                             AF.CREDITS_MUST_NOT_EXCEED_DEBITS, AF.HISTORY])) for _ in range(8)]
    batches, next_id = [], 1
    for _ in range(4):
        recs = []
        for _ in range(int(rng.integers(4, 32))):
            r = rng.random()
            f = (BAL_DR if rng.random() < 0.5 else BAL_CR) if r < 0.4 else (P if r < 0.5 else 0)
            recs.append(_t(next_id, int(rng.integers(1, 9)), int(rng.integers(1, 9)),
                           int(rng.integers(0, 60)), f,
                           timeout=int(rng.integers(0, 3)) if f == P else 0))
            next_id += 1
        batches.append((None, _tb(*recs)))
    return [_accs(*flags)], batches


def _scenario(name):
    """(account batches, [(timestamp or None, transfer batch)]) of one
    scenario; the stream of test_state_machine.py it ports in brackets."""
    from tigerbeetle_tpu.flags import AccountFlags as AF

    four = _accs(0, 0, 0, 0)
    if name == "linked_rollback":  # [test_linked_chain_rollback]
        return [four], [(None, _tb(_t(1, 1, 2, 10, L), _t(2, 1, 2, 0), _t(3, 3, 4, 5)))]
    if name == "chain_first_fail":  # [test_chain_first_fail_reports_own_code]
        return [four], [(None, _tb(_t(1, 1, 2, 10, L), _t(2, 1, 2, 0, L),
                                   _t(3, 1, 2, 0, ledger=0)))]
    if name == "chain_open":  # [test_chain_open_trailing]
        return [four], [(None, _tb(_t(1, 1, 2, 10), _t(2, 1, 2, 10, L), _t(3, 3, 4, 5, L)))]
    if name == "broken_chain_open":  # [test_chain_open_in_broken_chain]
        return [four], [(None, _tb(_t(1, 1, 2, 0, L), _t(2, 1, 2, 10, L)))]
    if name == "chains_mixed":  # [test_multiple_chains_mixed]
        return [_accs(*[0] * 6)], [(None, _tb(
            _t(1, 1, 2, 10, L), _t(2, 3, 4, 10), _t(3, 5, 6, 10, L), _t(4, 5, 99, 10, L),
            _t(5, 5, 6, 10), _t(6, 1, 6, 3)))]
    if name == "post_void":  # [test_pending_post_void]
        return [_accs(0, 0)], [
            (None, _tb(_t(1, 1, 2, 100, P), _t(2, 1, 2, 50, P), _t(3, 1, 2, 70, P))),
            (None, _tb(_t(10, flags=POST, pending_id=1), _t(11, flags=VOID, pending_id=2),
                       _t(12, flags=POST, pending_id=1), _t(13, flags=POST, pending_id=3,
                                                            amount=30, user_data_64=9),
                       _t(14, flags=VOID, pending_id=99))),
            (None, _tb(_t(20, flags=VOID, pending_id=3), _t(21, flags=POST, pending_id=2))),
        ]
    if name == "expired":  # a pending whose 1 s timeout passed before its post
        return [_accs(0, 0)], [
            (10_000, _tb(_t(1, 1, 2, 100, P, timeout=1), _t(2, 1, 2, 5, P, timeout=9))),
            (10_000 + 2_000_000_000, _tb(_t(10, flags=POST, pending_id=1),
                                         _t(11, flags=POST, pending_id=2))),
        ]
    if name == "same_batch_post":  # [test_post_pending_same_batch]
        return [_accs(0, 0)], [(None, _tb(_t(1, 1, 2, 100, P),
                                          _t(2, flags=POST, pending_id=1, amount=40)))]
    if name == "balancing":  # [test_balancing_transfers]
        return [_accs(0, 0)], [(None, _tb(_t(1, 2, 1, 70))),
                               (None, _tb(_t(2, 1, 2, 100, BAL_DR), _t(3, 1, 2, 100, BAL_DR)))]
    if name == "balancing_hot":  # [test_balancing_chain_on_hot_account]
        return [_accs(0, 0, 0)], [(None, _tb(_t(1, 2, 1, 100))),
                                  (None, _tb(*[_t(10 + k, 1, 3, 9, BAL_DR) for k in range(20)]))]
    if name == "balancing_sentinel":  # [test_balancing_zero_amount_sentinel]
        return [_accs(0, 0)], [(None, _tb(_t(1, 2, 1, 12345))),
                               (None, _tb(_t(2, 1, 2, 0, BAL_DR), _t(3, 2, 1, 0, BAL_CR)))]
    if name == "limits":  # [test_limit_flags_route_exact_kernel]
        return [_accs(AF.DEBITS_MUST_NOT_EXCEED_CREDITS, 0)], [(None, _tb(
            _t(1, 2, 1, 30), _t(2, 1, 2, 20), _t(3, 1, 2, 20)))]
    if name == "limits_history":  # [test_limit_and_history_mixed_batch]
        return [_accs(AF.DEBITS_MUST_NOT_EXCEED_CREDITS | AF.HISTORY, AF.HISTORY, 0)], [
            (None, _tb(_t(1, 3, 1, 50), _t(2, 1, 2, 30), _t(3, 1, 2, 30), _t(4, 1, 3, 20))),
            (None, _tb(_t(5, 2, 1, 7, P), _t(6, 1, 3, 1))),
        ]
    if name.startswith("random_limits"):  # [test_random_balancing_limits_heavy]
        return _random_limits(int(name[-1]))
    raise KeyError(name)


@pytest.mark.parametrize("name,routes", [
    ("linked_rollback", (1, 0)), ("chain_first_fail", (1, 0)), ("chain_open", (1, 0)),
    ("broken_chain_open", (1, 0)), ("chains_mixed", (1, 0)), ("post_void", (2, 0)),
    ("expired", (1, 0)), ("same_batch_post", (0, 1)), ("balancing", (1, 0)),
    ("balancing_hot", (1, 0)), ("balancing_sentinel", (1, 0)), ("limits", (1, 0)),
    ("limits_history", (2, 0)), ("random_limits0", None), ("random_limits1", None),
])
def test_exact_scenario_matches_reference(name, routes):
    """Each scenario through both machines: results, every account's and
    transfer's lookup bytes, every history account's history and the
    route counts equal; `routes` = (exact, serial) batches where fixed."""
    ref, port = _pair()
    accounts, batches = _scenario(name)
    for a in accounts:
        _both(ref, port, "create_accounts", a)
    max_id = 1
    for ts, batch in batches:
        want = ref.create_transfers(batch.copy(), ts)
        got = port.create_transfers(batch.copy(), ts)
        assert got.tobytes() == want.tobytes()
        max_id = max(max_id, int(batch["id_lo"].max()) + 1)
    ids = np.arange(1, len(accounts[0]) + 1, dtype=np.uint64)
    zero = np.zeros(len(ids), dtype=np.uint64)
    assert port.lookup_accounts(ids, zero).tobytes() == ref.lookup_accounts(ids, zero).tobytes()
    tids = np.arange(1, max_id, dtype=np.uint64)
    tzero = np.zeros(len(tids), dtype=np.uint64)
    assert port.lookup_transfers(tids, tzero).tobytes() == ref.lookup_transfers(tids, tzero).tobytes()
    for i in ids:
        assert port.get_account_history(int(i)) == ref.get_account_history(int(i))
    for k in ("exact_batches", "serial_batches", "bail_batches"):
        assert port.stats[k] == ref.stats[k], k
    if routes is not None:
        assert (port.stats["exact_batches"], port.stats["serial_batches"]) == routes
    else:
        assert port.stats["exact_batches"] + port.stats["bail_batches"] >= 1


def test_tracer_records_the_exact_entry():
    """An exact-route batch opens the exact kernel's device window and the
    sm.create_transfers.exact span, and lands in the call-shape registry."""
    from tigerbeetle_tpu_torch import devicestats, tracer

    tracer.enable()
    tracer.reset()
    try:
        port = PortSM(CFG, device="cpu")
        accounts, batches = _scenario("chains_mixed")
        port.create_accounts(accounts[0])
        port.create_transfers(batches[0][1])
        snap = tracer.snapshot()
        shapes = devicestats.observed_shapes()
    finally:
        tracer.disable()
        tracer.reset()
    assert snap["device.step.create_transfers_exact"]["count"] == 1
    assert snap["device.create_transfers_exact.dispatches"]["count"] == 1
    assert snap["sm.create_transfers.exact"]["count"] == 1
    assert shapes["create_transfers_exact"]
