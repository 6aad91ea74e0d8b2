"""The port's exact route (ops/commit_exact.py) against the reference
package's, exact.

The same staged batch, made with numpy from a seed, goes through
`tigerbeetle_tpu.ops.commit_exact.create_transfers_exact` (JAX, jit on the
CPU) and the port's plain PyTorch version, which runs for CPU tensors. New
state bytes, codes, amounts, dr_after, cr_after and bail must be equal:
integer semantics, so the tolerance is 0. The CUDA kernels are held
against the same plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tigerbeetle_tpu.ops import commit as ref_commit
from tigerbeetle_tpu.ops import commit_exact as ref
from tigerbeetle_tpu_torch.ops import commit as port_commit
from tigerbeetle_tpu_torch.ops import commit_exact as port
from tigerbeetle_tpu_torch.results import CreateTransferResult as TR

from exact_batches import (
    BALANCE_FIELDS, F_POST, F_VOID, PLAN_EDGES, SWEEP_EDGES, U32, empty, ids, limbs,
    pending_plus_posted, plan_edge, relay, strip, sweep_edge,
)
from exact_batches import batch as _gen_batch
from exact_batches import state as _gen_state

A = 1 << 12


def _state(rng, heavy=False):
    return _gen_state(rng, A, heavy)


def _batch(rng, kind, n):
    return _gen_batch(rng, kind, n, A)



def _ref_run(st, b, p, chain, host, plan, **kw):
    state = ref_commit.LedgerState(**{k: jnp.asarray(v) for k, v in st.items()})
    tb = ref_commit.TransferBatch(**{k: jnp.asarray(v) for k, v in b.items()})
    pi = ref.PendingInfo(**{k: jnp.asarray(v) for k, v in p.items()})
    out = ref.create_transfers_exact(
        state, tb, jnp.asarray(host), pi, jnp.asarray(chain),
        None if plan is None else ref.SortPlan(*(jnp.asarray(x) for x in plan)), **kw,
    )
    new, codes, amounts, dr_after, cr_after, bail = out
    return (
        [np.asarray(getattr(new, f)) for f in ref_commit.LedgerState._fields],
        np.asarray(codes), np.asarray(amounts),
        [np.asarray(x) for x in dr_after], [np.asarray(x) for x in cr_after],
        bool(bail),
    )


def _port_run(st, b, p, chain, host, plan, **kw):
    state = port_commit.state_from_reference(st, "cpu")
    tb = port_commit.TransferBatch(**{k: torch.from_numpy(v.copy()) for k, v in b.items()})
    pi, chain_t, plan_t = port_commit.exact_inputs_from_reference(
        ref.PendingInfo(**p), chain, plan, "cpu"
    )
    out = port.create_transfers_exact(
        state, tb, torch.from_numpy(host.copy()), pi, chain_t, plan_t, **kw
    )
    new, codes, amounts, dr_after, cr_after, bail = out
    return (
        [getattr(new, f).numpy() for f in port_commit.LedgerState._fields],
        codes.numpy(), amounts.numpy(),
        [x.numpy() for x in dr_after], [x.numpy() for x in cr_after],
        bool(bail),
    )


def _plan(st, b, p, chain):
    return ref.build_sort_plan(
        b["flags"], b["dr_slot"], b["cr_slot"], p["dr_slot"], p["cr_slot"],
        chain, p["group"], A,
    )


def _same(got, want):
    g_tables, g_codes, g_amounts, g_dr, g_cr, g_bail = got
    w_tables, w_codes, w_amounts, w_dr, w_cr, w_bail = want
    for f, g, w in zip(port_commit.LedgerState._fields, g_tables, w_tables):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), f
    assert g_codes.dtype == np.uint32
    assert np.array_equal(g_codes, w_codes)
    assert g_amounts.tobytes() == w_amounts.tobytes()
    for g, w in zip(g_dr + g_cr, w_dr + w_cr):
        assert g.tobytes() == w.tobytes()
    assert g_bail == w_bail


def _check(st, b, p, chain, host, with_plan=True, **kw):
    plan = _plan(st, b, p, chain) if with_plan else None
    want = _ref_run(st, b, p, chain, host, plan, **kw)
    _same(_port_run(st, b, p, chain, host, plan, **kw), want)
    return want


@pytest.mark.parametrize("with_plan", [True, False])
@pytest.mark.parametrize("kind", ["config3", "config4", "ladder"])
def test_matches_reference(kind, with_plan):
    """(a) config 3, (b) config 4, (c) every static and dynamic rung."""
    rng = np.random.default_rng({"config3": 1, "config4": 2, "ladder": 3}[kind])
    st = _state(rng, heavy=kind == "ladder")
    b, p, chain, host = _batch(rng, kind, 256)
    want = _check(st, b, p, chain, host, with_plan)
    codes = set(want[1].tolist())
    assert 0 in codes and len(codes) >= 3
    if kind == "ladder":
        reached = codes | set(host.tolist())
        for name in ("EXCEEDS_CREDITS", "EXCEEDS_DEBITS", "OVERFLOWS_CREDITS_POSTED",
                     "FLAGS_ARE_MUTUALLY_EXCLUSIVE", "LINKED_EVENT_FAILED",
                     "LINKED_EVENT_CHAIN_OPEN", "PENDING_TRANSFER_ALREADY_POSTED",
                     "OVERFLOWS_TIMEOUT", "DEBIT_ACCOUNT_NOT_FOUND",
                     "PENDING_ID_MUST_BE_DIFFERENT"):
            assert int(getattr(TR, name)) in reached, name


def test_sort_plan_matches_reference():
    rng = np.random.default_rng(4)
    for kind in ("config3", "ladder"):
        st = _state(rng)
        b, p, chain, _ = _batch(rng, kind, 128)
        args = (b["flags"], b["dr_slot"], b["cr_slot"], p["dr_slot"], p["cr_slot"],
                chain, p["group"], A)
        want = ref.build_sort_plan(*args)
        got = port.build_sort_plan(*args)
        for f, g, w in zip(port.SortPlan._fields, got, want):
            assert g.dtype == np.int32 and np.array_equal(g, w), f
        # the plain version of the kernel's in-function sort: the same plan
        tb = port_commit.TransferBatch(**{k: torch.from_numpy(v) for k, v in b.items()})
        pi, chain_t, _ = port_commit.exact_inputs_from_reference(
            ref.PendingInfo(**p), chain, None, "cpu")
        plain = port.sort_plan(tb, pi, chain_t, A)
        for f, g, w in zip(port.SortPlan._fields, plain, want):
            assert np.array_equal(g.numpy(), w), f


class _Plan(Exception):
    """Carries the SortPlan the reference built, out of its function."""


def _reference_plan(b, p, chain, a, monkeypatch):
    """The reference's own plan=None sort (commit_exact.py:474-519):
    create_transfers_exact_impl run eagerly until it builds its SortPlan.
    Nothing before the sort reads the balance tables, so they are stubs."""
    def capture(*fields):
        raise _Plan([np.asarray(x) for x in fields])

    monkeypatch.setattr(ref, "SortPlan", capture)
    n = len(chain)
    state = ref_commit.LedgerState(
        **{f: jnp.zeros((1, 4), jnp.uint32) for f in BALANCE_FIELDS},
        ledger=jnp.ones(a, jnp.uint32), flags=jnp.zeros(a, jnp.uint32),
    )
    tb = ref_commit.TransferBatch(**{k: jnp.asarray(v) for k, v in b.items()})
    pi = ref.PendingInfo(**{k: jnp.asarray(v) for k, v in p.items()})
    with pytest.raises(_Plan) as got:
        ref.create_transfers_exact_impl(state, tb, jnp.zeros(n, jnp.uint32), pi,
                                        jnp.asarray(chain))
    return got.value.args[0]


@pytest.mark.parametrize("case,n", PLAN_EDGES)
def test_sort_plan_edges_match_reference(case, n, monkeypatch):
    """The plain version of the device sort plan against the reference's
    in-function sort on the inputs a device sort is likeliest to get
    wrong, at A = 2^20 (slots up to A - 1; -1 sorts as A)."""
    a = 1 << 20
    b, p, chain = plan_edge(np.random.default_rng(sum(map(ord, case)) + n), case, n, a)
    want = _reference_plan(b, p, chain, a, monkeypatch)
    tb = port_commit.TransferBatch(**{k: torch.from_numpy(v) for k, v in b.items()})
    pi, chain_t, _ = port_commit.exact_inputs_from_reference(
        ref.PendingInfo(**p), chain, None, "cpu")
    got = port.sort_plan(tb, pi, chain_t, a)
    for f, g, w in zip(port.SortPlan._fields, got, want):
        assert g.dtype == torch.int32 and g.numpy().tobytes() == w.astype(np.int32).tobytes(), f
    if case == "one_slot":
        assert (got.head_pos == 0).all()


@pytest.mark.parametrize("max_sweeps", ["short", "exact"])
def test_sweep_limit(max_sweeps):
    """(d) a batch that needs more sweeps than max_sweeps bails; at the
    count it needs exactly, it does not."""
    st = _state(np.random.default_rng(5))
    b, p, chain, host = relay(st, 64, 12)
    # the seed passes the first link, each sweep one more, and the sweep
    # after the last link finds the batch stable: 12 sweeps for 12 links
    need = 12
    k = need - 1 if max_sweeps == "short" else need
    want = _check(st, b, p, chain, host, max_sweeps=k, has_pv=False, has_chains=False)
    assert want[5] == (max_sweeps == "short")


def test_pending_removal_underflow_bails():
    """(e) post/void removals larger than the pending balance."""
    rng = np.random.default_rng(6)
    st = _state(rng)
    b, p, chain, host = _batch(rng, "underflow", 128)
    assert p["found"].any()
    want = _check(st, b, p, chain, host, has_chains=False)
    assert want[5]


@pytest.mark.parametrize("case", ["after_posting", "cured"])
def test_pending_plus_posted(case):
    """(f) after_posting: amounts near 2^128 posted (through post events
    whose pending the store did not resolve, so no amount rung stops
    them) onto a row whose pending + posted overflows only after posting:
    bail. cured: a row that overflows before the batch, whose pending a
    void removes, so no row overflows after it: no bail."""
    rng = np.random.default_rng(7)
    st = _state(rng)
    b, p, chain, host = pending_plus_posted(rng, st, 64, cured=case == "cured")
    want = _check(st, b, p, chain, host)
    assert want[5] == (case == "after_posting")
    assert (want[1][:8] == 0).all()


@pytest.mark.parametrize("has_pv,has_chains", [(False, False), (False, True), (True, False)])
def test_specialisations(has_pv, has_chains):
    """(g) the flags drop work: equal to the reference's specialisation on
    batches that satisfy them (with and without a plan)."""
    rng = np.random.default_rng(8)
    st = _state(rng)
    b, p, chain, host = _batch(rng, "config3", 128)
    strip(b, p, chain, host, has_pv, has_chains)
    for with_plan in (True, False):
        _check(st, b, p, chain, host, with_plan, has_pv=has_pv, has_chains=has_chains)


def test_post_against_not_found_accounts():
    """A post whose pending's account slot is -1 (not found) posts at
    row A − 1, as the reference's scatter counts a negative slot from the
    end; the gathers clip it to row 0."""
    rng = np.random.default_rng(9)
    st = _state(rng)
    b, p = empty(16)
    b["id"] = ids(rng, 16)
    b["flags"][:4] = F_POST
    b["pending_id"][:4, 0] = 5 + np.arange(4)
    p["group"][:4] = np.arange(4)
    p["found"][:4] = True
    p["amount"][:4, 0] = 3
    p["dr_slot"][:4] = -1
    p["cr_slot"][:4] = [A - 1, 3, -1, 5]
    st["debits_pending"][A - 1] = limbs(100)
    st["credits_pending"][A - 1] = limbs(100)
    host = np.where(np.arange(16) < 4, 0, int(TR.ID_MUST_NOT_BE_ZERO)).astype(U32)
    want = _check(st, b, p, np.arange(16, dtype=np.int32), host)
    assert (want[1][:4] == 0).all()


@pytest.mark.parametrize("case", sorted({c for c, _ in SWEEP_EDGES}))
def test_sweep_edges_match_reference(case):
    """(h) the sweep kernel's edge batches (tests/exact_batches.py
    sweep_edge, at n = 256 or 1 on A = 2^12; the card runs them larger):
    one account under every record, segment heads on tile boundaries, one
    chain over the batch, one event, unstable at max_sweeps, an old
    overflowed row no event touches."""
    n = min(dict(SWEEP_EDGES)[case], 256)
    st, b, p, chain, host, kw, must_bail = sweep_edge(np.random.default_rng(10), case, n, A)
    want = _check(st, b, p, chain, host, **kw)
    if must_bail is not None:
        assert want[5] == must_bail
