"""The port's multi-device commit (tigerbeetle_tpu_torch/parallel/) against
the reference package's parallel/ on the 8-device virtual CPU mesh.

The reference runs on its virtual mesh (tests/conftest.py gives jax 8 CPU
devices); the port on `make_mesh([cpu] * 8)`, the same dp 2 × shard 4
layout. Both routes of the port run: "plain", the reference's step
written out device by device (what a mesh of CPUs runs), and "kernels",
the orchestration the card runs (sharded validate / apply / read and the
exact kernel's external-base mode), here through the kernels' plain
versions. The same numpy inputs, made from a seed, go to both packages;
codes, amounts, post-event balances, bail, the dense balance tables and
the state machines' results and lookups must be byte-equal (tolerance:
exact, integer state).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tigerbeetle_tpu import types
from tigerbeetle_tpu.constants import Config
from tigerbeetle_tpu.flags import AccountFlags, TransferFlags
from tigerbeetle_tpu.models.state_machine import StateMachine as RefSM
from tigerbeetle_tpu.ops import commit as ref_commit
from tigerbeetle_tpu.ops import commit_exact as ref_exact
from tigerbeetle_tpu.parallel import sharding as ref_sharding
from tigerbeetle_tpu.parallel.sharded_ops import ShardedOps as RefShardedOps
from tigerbeetle_tpu_torch.models.state_machine import StateMachine as PortSM
from tigerbeetle_tpu_torch.ops import commit as C
from tigerbeetle_tpu_torch.ops import commit_exact as E
from tigerbeetle_tpu_torch.parallel import sharding as S
from tigerbeetle_tpu_torch.parallel.sharded_ops import ShardedOps

import exact_batches as X

A = 1 << 10  # accounts capacity (divisible by the shard axis)
N = 256  # batch size
CPU = torch.device("cpu")
ROUTES = {"plain": (S.sharded_commit_plain, S.sharded_commit_exact_plain),
          "kernels": (S.sharded_commit, S.sharded_commit_exact)}


# --- fixtures: one reference mesh and its jitted steps per module ---------


@pytest.fixture(scope="module")
def ref_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return ref_sharding.make_mesh(8)


@pytest.fixture(scope="module")
def ref_fast(ref_mesh):
    return ref_sharding.make_sharded_commit(ref_mesh, A)


@pytest.fixture(scope="module")
def ref_exact_step(ref_mesh):
    return ref_sharding.make_sharded_commit_exact(ref_mesh, A)


@pytest.fixture(scope="module")
def mesh():
    return S.make_mesh([CPU] * 8)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _ref_place(dense, ref_mesh):
    return ref_sharding._place(
        ref_commit.LedgerState(**{k: jnp.asarray(v) for k, v in dense.items()}), ref_mesh
    )


def _ref_dense(state):
    return {f: np.asarray(getattr(state, f)) for f in ref_commit.LedgerState._fields}


def _assert_dense(port_state, mesh, want):
    got = S.sharded_state_to_numpy(port_state, mesh)
    for f in ref_commit.LedgerState._fields:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def _assert_replicas(state, mesh):
    """Every dp copy of a shard is byte-equal to dp row 0's."""
    for k, sh in enumerate(state.shards):
        row0 = state.shards[k % mesh.shard]
        for x, y in zip(sh, row0):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def _np(x):
    return x.view(torch.int32).numpy().view(np.uint32) if x.dtype == torch.uint32 else x.numpy()


# --- the fast route (reference make_sharded_commit) ----------------------


def _setup(rng, n=N):
    """The reference test's setup (tests/test_sharding.py _setup): 100
    accounts, a batch over them with 30% pendings, some zero amounts and
    host codes. Returns (dense state after registration, batch, host)."""
    n_accounts = 100
    dense = {f: np.zeros((A, 4), np.uint32) for f in C.BALANCE_FIELDS}
    dense["ledger"] = np.zeros(A, np.uint32)
    dense["ledger"][:n_accounts] = 1
    dense["flags"] = np.zeros(A, np.uint32)
    b = {
        "id": types.u64_pair_to_limbs(np.arange(1, n + 1, dtype=np.uint64), np.zeros(n, np.uint64)),
        "dr_slot": rng.integers(0, n_accounts, n).astype(np.int32),
        "cr_slot": rng.integers(0, n_accounts, n).astype(np.int32),
        "amount": types.u64_pair_to_limbs(
            rng.integers(1, 10_000, n).astype(np.uint64), np.zeros(n, np.uint64)),
        "pending_id": np.zeros((n, 4), np.uint32),
        "timeout": np.zeros(n, np.uint32),
        "ledger": np.ones(n, np.uint32),
        "code": np.full(n, 7, np.uint32),
        "flags": (rng.random(n) < 0.3).astype(np.uint32) * np.uint32(C.F_PENDING),
        "timestamp": types.u64_to_limbs(np.arange(1, n + 1, dtype=np.uint64)),
    }
    b["amount"][::17] = 0
    host = np.zeros(n, np.uint32)
    host[::23] = 12
    return dense, b, host


def _fast_both(ref_step, ref_mesh, mesh, route, dense, b, host):
    """The reference's sharded fast step and the port's on the same
    inputs; asserts equal codes, bail and tables. Returns (port state,
    codes, bail)."""
    rs, rc, rbail = ref_step(
        _ref_place(dense, ref_mesh), ref_commit.TransferBatch(**{k: jnp.asarray(v) for k, v in b.items()}),
        jnp.asarray(host),
    )
    fast = ROUTES[route][0]
    ps, pc, pbail = fast(mesh, A, S.sharded_state_from_reference(dense, mesh),
                         C.TransferBatch(**{k: _t(v) for k, v in b.items()}), _t(host))
    np.testing.assert_array_equal(_np(pc), np.asarray(rc))
    assert bool(pbail) == bool(rbail)
    _assert_dense(ps, mesh, _ref_dense(rs))
    _assert_replicas(ps, mesh)
    return ps, pc, bool(pbail)


@pytest.mark.parametrize("route", ROUTES)
def test_sharded_matches_reference(ref_mesh, ref_fast, mesh, route):
    dense, b, host = _setup(np.random.default_rng(42))
    _, codes, bail = _fast_both(ref_fast, ref_mesh, mesh, route, dense, b, host)
    assert not bail and int((_np(codes) == 0).sum()) > N // 2
    # ... and the single-device port on the same inputs.
    new1, codes1, bail1 = C.create_transfers_fast(
        C.state_from_reference(dense, CPU), C.TransferBatch(**{k: _t(v) for k, v in b.items()}),
        _t(host))
    np.testing.assert_array_equal(_np(codes1), _np(codes))
    assert not bool(bail1)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("where", ["shard3", "dp1"])
def test_bail_from_one_part_of_the_mesh(ref_mesh, ref_fast, mesh, route, where):
    """shard3: the only overflow is pending + posted on a row of shard 3
    that no event touches; dp1: the only unsupported flag (linked) is on
    an event of dp slice 1. Either bails the whole mesh's result."""
    dense, b, host = _setup(np.random.default_rng(7))
    if where == "shard3":
        row = 3 * (A // 4) + 17
        dense["debits_pending"][row] = [0, 0, 0, 1 << 31]
        dense["debits_posted"][row] = [0, 0, 0, 1 << 31]
    else:
        b["flags"][N - 3] |= np.uint32(C.F_LINKED)
    _, _, bail = _fast_both(ref_fast, ref_mesh, mesh, route, dense, b, host)
    assert bail


@pytest.mark.parametrize("route", ROUTES)
def test_dp_padding(ref_mesh, mesh, route):
    """n not a multiple of dp: both facades pad (-1 slots, never-applied
    host codes) and cut the codes back to n; the pad's -1 slots post on no
    shard."""
    dense, b, host = _setup(np.random.default_rng(11), n=N - 1)
    ref_ops = RefShardedOps(ref_mesh, A)
    rs, rc, rbail = ref_ops.create_transfers_fast(
        _ref_place(dense, ref_mesh), ref_commit.TransferBatch(**b), host)
    ops = ShardedOps(mesh, A)
    ops._fast = lambda *a: ROUTES[route][0](mesh, A, *a)
    ps, pc, pbail = ops.create_transfers_fast(
        S.sharded_state_from_reference(dense, mesh),
        C.TransferBatch(**{k: _t(v) for k, v in b.items()}), _t(host))
    assert pc.shape == (N - 1,)
    np.testing.assert_array_equal(_np(pc), np.asarray(rc))
    assert not bool(pbail) and not bool(rbail)
    _assert_dense(ps, mesh, _ref_dense(rs))


# --- the exact route (reference make_sharded_commit_exact) ---------------


def _exact_reference_setup(rng):
    """The reference test's exact batch (tests/test_sharding.py
    test_sharded_exact_matches_single): balancing flags, a linked chain,
    seeded balances."""
    dense, b, _ = _setup(rng)
    flags = np.zeros(N, np.uint32)
    bal = rng.random(N) < 0.4
    flags[bal] = np.where(rng.random(int(bal.sum())) < 0.5, np.uint32(C.F_BAL_DR), np.uint32(C.F_BAL_CR))
    flags[10] = np.uint32(C.F_LINKED)
    chain = np.arange(N, dtype=np.int32)
    chain[11] = 10
    b["flags"] = flags
    for f in C.BALANCE_FIELDS:
        dense[f][:100, 0] = 1_000_000
    pending = {
        "found": np.zeros(N, bool), "amount": np.zeros((N, 4), np.uint32),
        "dr_slot": np.full(N, -1, np.int32), "cr_slot": np.full(N, -1, np.int32),
        "timestamp": np.zeros((N, 2), np.uint32), "timeout": np.zeros(N, np.uint32),
        "base_fulfillment": np.full(N, E.FULFILL_NONE, np.int32),
        "group": np.full(N, N, np.int32),
    }
    return dense, b, pending, chain, np.zeros(N, np.uint32)


def _exact_inputs(kind, seed):
    if kind == "reference":
        return _exact_reference_setup(np.random.default_rng(seed))
    rng = np.random.default_rng(seed)
    dense = X.state(rng, A, heavy=kind == "ladder")
    b, p, chain, host = X.batch(rng, kind, N, A)
    return dense, b, p, chain, host


@pytest.fixture(scope="module")
def ref_exact_out(ref_mesh, ref_exact_step):
    """kind -> the reference's sharded exact step on that kind's inputs
    (each computed once, for both routes)."""
    cache = {}

    def run(kind, dense, b, p, chain, host):
        if kind not in cache:
            out = ref_exact_step(
                _ref_place(dense, ref_mesh),
                ref_commit.TransferBatch(**{k: jnp.asarray(v) for k, v in b.items()}),
                jnp.asarray(host), ref_exact.PendingInfo(**{k: jnp.asarray(v) for k, v in p.items()}),
                jnp.asarray(chain),
            )
            cache[kind] = jax.tree_util.tree_map(np.asarray, out)
        return cache[kind]

    return run


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kind", ["reference", "config3", "config4", "ladder", "underflow"])
def test_sharded_exact_matches_reference(ref_exact_out, mesh, route, kind):
    dense, b, p, chain, host = _exact_inputs(kind, {"reference": 77}.get(kind, 5))
    rs, rcodes, ramounts, rdr, rcr, rbail = ref_exact_out(kind, dense, b, p, chain, host)
    exact = ROUTES[route][1]
    ps, pcodes, pamounts, pdr, pcr, pbail = exact(
        mesh, A, S.sharded_state_from_reference(dense, mesh),
        C.TransferBatch(**{k: _t(v) for k, v in b.items()}), _t(host),
        E.PendingInfo(**{k: _t(v) for k, v in p.items()}), _t(chain),
    )
    np.testing.assert_array_equal(_np(pcodes), np.asarray(rcodes))
    np.testing.assert_array_equal(_np(pamounts), np.asarray(ramounts))
    for got, want in zip((*pdr, *pcr), (*rdr, *rcr)):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert bool(pbail) == bool(rbail)
    assert kind != "underflow" or bool(pbail)
    assert kind == "underflow" or int((_np(pcodes) == 0).sum()) > 0
    _assert_dense(ps, mesh, _ref_dense(rs))
    _assert_replicas(ps, mesh)


def test_external_base_mode_matches_the_exact_route():
    """The exact kernel's external-base mode (plain version): given the
    records' pre-batch balances, its codes, amounts and post-event
    balances are the exact route's, and posting its eff slots under its
    masks on one whole-table shard gives the exact route's tables."""
    rng = np.random.default_rng(21)
    dense = X.state(rng, A)
    b, p, chain, host = X.batch(rng, "config3", N, A)
    st = C.state_from_reference(dense, CPU)
    args = (C.TransferBatch(**{k: _t(v) for k, v in b.items()}), _t(host),
            E.PendingInfo(**{k: _t(v) for k, v in p.items()}), _t(chain))
    want = E.create_transfers_exact(st, *args)
    eff = lambda side: torch.where((args[0].flags.view(torch.int32) & (C.F_POST | C.F_VOID)) != 0,
                                   getattr(args[2], side), getattr(args[0], side))
    base = E.Observed(*S.sharded_read(st, torch.cat([eff("dr_slot"), eff("cr_slot")]), 0, A))
    got = E.create_transfers_exact_external(st, base, *args)
    for g, w in zip((got[0], got[1], *got[2], *got[3], got[7]),
                    (want[1], want[2], *want[3], *want[4], want[5])):
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.uint32 else g,
                           w.view(torch.int32) if w.dtype == torch.uint32 else w)
    new, bail = S.sharded_apply(st, got[4], got[5], got[1], args[2].amount, got[6], 0)
    assert not bool(bail)
    for f in C.BALANCE_FIELDS:
        assert torch.equal(getattr(new, f).view(torch.int32), getattr(want[0], f).view(torch.int32))


# --- layout, slot conventions, mesh shapes --------------------------------


def test_sharded_state_placement(mesh):
    state = S.init_sharded_state(A, mesh)
    assert len(state.shards) == 8 and state.ledger.shape == (A,)
    for sh, d in zip(state.shards, mesh.flat):
        assert sh.debits_posted.shape == (A // 4, 4) and sh.debits_posted.device == d
        assert sh.ledger.shape == (A,) and sh.flags.shape == (A,)
    with pytest.raises(AssertionError):
        S.init_sharded_state(A + 2, mesh)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shapes(ref_mesh, n):
    """The reference's dp rule: 8 devices give 2 × 4."""
    m = S.make_mesh([CPU] * n)
    ref = ref_sharding.make_mesh(n)
    assert (m.dp, m.shard) == (ref.shape["dp"], ref.shape["shard"])
    assert m.axis_names == ref.axis_names
    assert m.dp * m.shard == n


def test_make_mesh_needs_enough_cuda_devices():
    """With no explicit list the mesh takes CUDA devices and raises if too
    few exist; it never drops to fewer cards or to the CPU."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError):
        S.make_mesh(have + 1)
    if have == 0:
        with pytest.raises(RuntimeError):
            S.make_mesh()


def test_slot_conventions(mesh):
    """write_balances: a slot in [-A, 0) counts from the end of the global
    table, a slot outside [-A, A) is dropped (normalized globally before
    it is localized). read_balances: slots clip to [0, A-1], so -1 reads
    row 0 (shard 0's) and A + 5 reads row A - 1 (shard 3's)."""
    rng = np.random.default_rng(3)
    dense = X.state(rng, A)
    slots = np.array([-1, -A, -(A // 4) - 1, 5, A // 4, A - 1, A, A + 9, -A - 1, 700], np.int32)
    rows = [rng.integers(0, 1 << 32, (len(slots), 4), dtype=np.uint64).astype(np.uint32)
            for _ in range(4)]
    ref = ref_commit.write_balances(
        ref_commit.LedgerState(**{k: jnp.asarray(v) for k, v in dense.items()}),
        jnp.asarray(slots), *(jnp.asarray(r) for r in rows))
    ops = ShardedOps(mesh, A)
    state = ops.write_balances(S.sharded_state_from_reference(dense, mesh), _t(slots),
                               *(_t(r) for r in rows))
    _assert_dense(state, mesh, _ref_dense(ref))
    _assert_replicas(state, mesh)
    reads = np.array([-1, 0, A // 4 - 1, A // 4, A - 1, A + 5, 300, -7], np.int32)
    want = ref_commit.read_balances(ref, jnp.asarray(reads))
    for g, w in zip(ops.read_balances(state, _t(reads)), want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


REG_CASES = {  # (k, share of rows masked in, slots placed at the front)
    "edges": (256, 0.9, [-1, -A, A, -A - 1, -(A // 4) - 1, A // 4]),
    "mask_none": (64, 0.0, [-1, -A, A, -A - 1]),
    "k0": (0, 1.0, []),
    "k1": (1, 1.0, [-A]),
}


@pytest.mark.parametrize("case", list(REG_CASES))
def test_register_accounts_sharded_matches_reference(ref_mesh, mesh, monkeypatch, case):
    """Registration on the mesh: one grouped call for each distinct device
    (one here: the eight shards of make_mesh([cpu] * 8)), over every table
    that device holds, and every shard's ledger and flags equal to the
    reference's register_accounts_sharded on its 8-device mesh. Slots -1
    and -A count from the end; A and -A - 1 are dropped, as masked rows."""
    k, share, edge = REG_CASES[case]
    rng = np.random.default_rng(len(case) * 31 + k)
    dense = X.state(rng, A)
    # distinct slots (the contract): the random ones avoid the edges' rows
    free = np.setdiff1d(np.arange(A), [0, A - 1, A - A // 4 - 1, A // 4])
    slots = rng.choice(free, k, replace=False).astype(np.int32)
    slots[:len(edge)] = edge
    ledger = rng.integers(1, 9, k).astype(np.uint32)
    flags = rng.integers(0, 1 << 16, k).astype(np.uint32)
    mask = rng.random(k) < share
    calls = []
    grouped = S.register_accounts_grouped

    def counted(tables, *args):
        calls.append(len(tables))
        return grouped(tables, *args)

    monkeypatch.setattr(S, "register_accounts_grouped", counted)
    state = S.register_accounts_sharded(mesh, S.sharded_state_from_reference(dense, mesh),
                                        *(_t(x) for x in (slots, ledger, flags, mask)))
    assert calls == [8]
    ref = ref_sharding.register_accounts_sharded(
        ref_mesh, _ref_place(dense, ref_mesh),
        *(jnp.asarray(x) for x in (slots, ledger, flags, mask)))
    want = _ref_dense(ref)
    for sh in state.shards:
        np.testing.assert_array_equal(_np(sh.ledger), want["ledger"])
        np.testing.assert_array_equal(_np(sh.flags), want["flags"])
    _assert_dense(state, mesh, want)


WRITE_LAYOUTS = {"dp1": (4, 1), "dp2": (8, 2), "dp4": (16, 4), "33 tables": (33, 33)}


@pytest.mark.parametrize("layout", list(WRITE_LAYOUTS))
def test_write_balances_sharded_matches_reference(monkeypatch, layout):
    """The serial writeback on meshes of dp 1, 2 and 4 (x shard 4) and on
    33 tables (dp 33 x shard 1: more than a launch's GROUP_TABLES): one
    grouped call for the one device, through write_balances_grouped_plain,
    and the dense tables equal the reference's write_balances on its dense
    state; every dp replica byte-equal. Slots -1 and -A count from the
    end, -A - 1, A and A + 9 are dropped, and each shard's first and last
    rows land."""
    n, dp = WRITE_LAYOUTS[layout]
    mesh = S.make_mesh([CPU] * n, dp=dp)
    rows = A // mesh.shard
    rng = np.random.default_rng(n)
    dense = X.state(rng, A)
    # distinct landing slots: -1 is row A - 1 and -A row 0, so the edges
    # name every other shard edge
    edge = [-1, -A, -A - 1, A, A + 9] + [s * rows for s in range(1, mesh.shard)] + [
        s * rows + rows - 1 for s in range(mesh.shard - 1)]
    free = np.setdiff1d(np.arange(A), np.array(edge) % A)
    slots = np.concatenate([edge, rng.choice(free, 200, replace=False)]).astype(np.int32)
    blocks = [rng.integers(0, 1 << 32, (len(slots), 4), dtype=np.uint64).astype(np.uint32)
              for _ in range(4)]
    ref = ref_commit.write_balances(
        ref_commit.LedgerState(**{k: jnp.asarray(v) for k, v in dense.items()}),
        jnp.asarray(slots), *(jnp.asarray(r) for r in blocks))
    calls = []
    grouped = S.write_balances_grouped

    def counted(tables, *args):
        calls.append(len(tables))
        return grouped(tables, *args)

    monkeypatch.setattr(S, "write_balances_grouped", counted)
    state = ShardedOps(mesh, A).write_balances(
        S.sharded_state_from_reference(dense, mesh), _t(slots), *(_t(r) for r in blocks))
    assert calls == [n]
    _assert_dense(state, mesh, _ref_dense(ref))
    _assert_replicas(state, mesh)


def _mesh_run(mesh, dense, seed):
    """One fast and one exact commit on `mesh`, from the same inputs."""
    _, b, host = _setup(np.random.default_rng(seed))
    st, codes, bail = ROUTES["kernels"][0](mesh, A, S.sharded_state_from_reference(dense, mesh),
                                           C.TransferBatch(**{k: _t(v) for k, v in b.items()}), _t(host))
    assert not bool(bail)
    d2 = S.sharded_state_to_numpy(st, mesh)
    _, eb, p, chain, ehost = _exact_inputs("config3", seed)
    out = ROUTES["kernels"][1](mesh, A, S.sharded_state_from_reference(d2, mesh),
                               C.TransferBatch(**{k: _t(v) for k, v in eb.items()}), _t(ehost),
                               E.PendingInfo(**{k: _t(v) for k, v in p.items()}), _t(chain))
    _assert_replicas(out[0], mesh)
    return _np(codes), [_np(x) for x in (out[1], out[2])], S.sharded_state_to_numpy(out[0], mesh)


@pytest.mark.parametrize("other", ["dp1x8", "dp4x2", "1x1"])
def test_mesh_layouts_agree(other):
    """dp = 1 and dp = 4 (and one device) give what dp = 2 × shard 4
    gives, bytes and all."""
    dp, n = {"dp1x8": (1, 8), "dp4x2": (4, 8), "1x1": (1, 1)}[other]
    dense = X.state(np.random.default_rng(9), A)
    base = _mesh_run(S.make_mesh([CPU] * 8, dp=2), dense, 13)
    got = _mesh_run(S.make_mesh([CPU] * n, dp=dp), dense, 13)
    np.testing.assert_array_equal(got[0], base[0])
    for g, w in zip(got[1], base[1]):
        np.testing.assert_array_equal(g, w)
    for f in base[2]:
        np.testing.assert_array_equal(got[2][f], base[2][f])


# --- the state machine on a mesh ------------------------------------------

CFG = Config(name="mesh", accounts_max=A, transfers_max=1 << 14, batch_max=64)
N_ACCOUNTS = 24


def _accounts():
    return types.batch(
        [types.account(
            id=1 + i, ledger=1, code=10,
            flags=int(AccountFlags.DEBITS_MUST_NOT_EXCEED_CREDITS) if i % 6 == 0 else 0)
         for i in range(N_ACCOUNTS)],
        types.ACCOUNT_DTYPE,
    )


def _traffic(rng, n_batches=4):
    """The reference test's mix (tests/test_sharding.py
    test_state_machine_on_mesh_oracle_parity): simple and pending
    transfers, balancing, post/void of earlier pendings; then a batch with
    amounts near 2^128 on two accounts (a bail into the serial route and
    its sharded writeback). Top-bit ids."""
    next_id = (1 << 63) + 1
    pendings, batches = [], []
    for _ in range(n_batches):
        recs, new_p = [], []
        for _ in range(int(rng.integers(8, 40))):
            r = rng.random()
            if r < 0.15 and pendings:
                recs.append(types.transfer(
                    id=next_id, pending_id=int(rng.choice(pendings)), ledger=1, code=10,
                    amount=int(rng.integers(0, 30)),
                    flags=int(TransferFlags.POST_PENDING_TRANSFER if rng.random() < 0.6
                              else TransferFlags.VOID_PENDING_TRANSFER)))
            elif r < 0.35:
                recs.append(types.transfer(
                    id=next_id, debit_account_id=int(rng.integers(1, N_ACCOUNTS + 1)),
                    credit_account_id=int(rng.integers(1, N_ACCOUNTS + 1)),
                    amount=int(rng.integers(0, 60)), ledger=1, code=10,
                    flags=int(TransferFlags.BALANCING_DEBIT if rng.random() < 0.5
                              else TransferFlags.BALANCING_CREDIT)))
            else:
                flags = int(TransferFlags.PENDING) if rng.random() < 0.3 else 0
                recs.append(types.transfer(
                    id=next_id, debit_account_id=int(rng.integers(1, N_ACCOUNTS + 1)),
                    credit_account_id=int(rng.integers(1, N_ACCOUNTS + 1)),
                    amount=int(rng.integers(1, 50)), ledger=1, code=10, flags=flags))
                if flags:
                    new_p.append(next_id)
            next_id += 1
        batches.append(types.batch(recs, types.TRANSFER_DTYPE))
        pendings += new_p
    simple = [types.transfer(id=next_id + i, debit_account_id=2 + (i % 3), credit_account_id=8,
                             amount=int(rng.integers(1, 1000)), ledger=1, code=10)
              for i in range(40)]
    batches.append(types.batch(simple, types.TRANSFER_DTYPE))
    huge = [types.transfer(id=next_id + 100 + i, debit_account_id=3, credit_account_id=4,
                           amount=(1 << 128) - 1 - int(rng.integers(0, 1 << 20)), ledger=1, code=10)
            for i in range(4)]
    batches.append(types.batch(huge, types.TRANSFER_DTYPE))
    return batches, next_id + 200


def _drive(machines, batches):
    results = [m.create_accounts(_accounts()) for m in machines]
    for r in results[1:]:
        assert r.tobytes() == results[0].tobytes()
    for ev in batches:
        results = [m.create_transfers(ev.copy()) for m in machines]
        for r in results[1:]:
            assert r.tobytes() == results[0].tobytes()


def _lookups_equal(a, b, max_id):
    ids = np.arange(1, N_ACCOUNTS + 1, dtype=np.uint64)
    zero = np.zeros(len(ids), np.uint64)
    assert a.lookup_accounts(ids, zero).tobytes() == b.lookup_accounts(ids, zero).tobytes()
    tids = np.arange((1 << 63) + 1, max_id, dtype=np.uint64)
    tzero = np.zeros(len(tids), np.uint64)
    got = a.lookup_transfers(tids, tzero)
    assert len(got) > 0 and got.tobytes() == b.lookup_transfers(tids, tzero).tobytes()


def test_state_machine_on_mesh_matches_reference(ref_mesh, mesh):
    """The whole StateMachine (prefetch, routing, the fast, exact and
    serial routes, the serial route's sharded writeback) over slot-sharded
    state: the reference's StateMachine(backend="jax", mesh=...) and the
    port's StateMachine(mesh=...) answer the same stream byte for byte."""
    batches, max_id = _traffic(np.random.default_rng(99))
    ref = RefSM(CFG, backend="jax", mesh=ref_mesh)
    port = PortSM(CFG, mesh=mesh)
    _drive([ref, port], batches)
    _lookups_equal(port, ref, max_id)
    for k in ("fast_batches", "exact_batches", "serial_batches", "bail_batches"):
        assert port.stats[k] == ref.stats[k], k
    assert port.stats["exact_batches"] >= 3 and port.stats["bail_batches"] == 1, port.stats
    _assert_dense(port.state, mesh, _ref_dense(ref.state))
    _assert_replicas(port.state, mesh)
    assert port.create_transfers_dispatch(batches[0], port.prepare("create_transfers", 1)) is None
    assert port.dispatch_depth_default() == 1


def test_state_machine_on_a_one_device_mesh_matches_the_single_device_port():
    batches, max_id = _traffic(np.random.default_rng(5))
    on_mesh = PortSM(CFG, mesh=S.make_mesh([CPU]))
    single = PortSM(CFG, device="cpu")
    _drive([on_mesh, single], batches)
    _lookups_equal(on_mesh, single, max_id)
    assert on_mesh.stats == single.stats
    dense = S.sharded_state_to_numpy(on_mesh.state, on_mesh.mesh)
    for f, t in zip(C.LedgerState._fields, single.state):
        np.testing.assert_array_equal(dense[f], _np(t))
