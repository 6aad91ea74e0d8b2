"""The mesh's grouped validation and grouped read
(tigerbeetle_tpu_torch/parallel/sharding.py sharded_validate_grouped,
sharded_read_grouped) against the reference package's parallel/ on its
8-device virtual CPU mesh.

The grouped validation's plain version (what a CPU tensor runs) validates
every dp slice of a batch into one gathered layout: its codes and its
routes' unsupported bits must equal the reference's make_sharded_commit
(codes and bail, :113), and its routes the reference's validate_simple /
merge_codes masks. The grouped read's plain version must equal the
reference's dense read_balances and the reference's sharded exact base
read (make_sharded_commit_exact balance_read, :215-231: each shard's owned
rows, psum over "shard"). On make_mesh([cpu] * 8) at dp 1, 2 and 4 the
commits and the lookups make one grouped call a device and no one-slice
or one-shard call, and the dp gather of one card's parts is the batch's
own tensor. The same numpy inputs, made from a seed, go to both packages
(tolerance: exact, integer state).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tigerbeetle_tpu.ops import commit as ref_commit
from tigerbeetle_tpu.parallel import sharding as ref_sharding
from tigerbeetle_tpu_torch.ops import commit as C
from tigerbeetle_tpu_torch.ops import commit_exact as E
from tigerbeetle_tpu_torch.parallel import sharding as S

import exact_batches as X

A = 1 << 10
N = 256
M = N // 2  # a dp slice of the reference's 2 x 4 mesh
CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.view(torch.int32).numpy().view(np.uint32) if x.dtype == torch.uint32 else x.numpy()


@pytest.fixture(scope="module")
def ref_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return ref_sharding.make_mesh(8)


# --- the grouped validation ----------------------------------------------

UNSUPPORTED = ("none", "slice1", "both")


def _ladder_batch(rng, unsupported):
    """n = N events reaching every rung of the fast ladder (zero and
    all-ones ids, pending ids, timeouts, zero amounts, ledgers and codes,
    slots -1 and >= A, ledger mismatches, reserved flags, host codes),
    amounts small enough that no posting overflows; linked flags (the
    unsupported kind) in no dp slice, in slice 1 only, or in both."""
    b = {
        "id": rng.integers(0, 4, (N, 4)).astype(np.uint32),
        "dr_slot": rng.integers(-1, A + 2, N).astype(np.int32),
        "cr_slot": rng.integers(0, 64, N).astype(np.int32),
        "amount": rng.integers(0, 3, (N, 4)).astype(np.uint32),
        "pending_id": (rng.random((N, 4)) < 0.01).astype(np.uint32),
        "timeout": (rng.random(N) < 0.05).astype(np.uint32),
        "ledger": rng.integers(0, 3, N).astype(np.uint32),
        "code": rng.integers(0, 3, N).astype(np.uint32),
        "flags": rng.choice([0, 0, 0, 2, 64], N).astype(np.uint32),
        "timestamp": np.ones((N, 2), np.uint32),
    }
    b["id"][:3] = 0xFFFFFFFF  # ID_MUST_NOT_BE_INT_MAX
    b["timestamp"][3] = 0xFFFFFFFF  # OVERFLOWS_TIMEOUT under a timeout
    b["timeout"][3], b["flags"][3] = 5, 2
    if unsupported in ("slice1", "both"):
        b["flags"][M + 7] |= np.uint32(C.F_LINKED)
    if unsupported == "both":
        b["flags"][5] |= np.uint32(C.F_LINKED)
    host = rng.choice([0, 0, 0, 8, 12], N).astype(np.uint32)
    return b, host


def _dense(rng):
    dense = {f: np.zeros((A, 4), np.uint32) for f in C.BALANCE_FIELDS}
    for f in C.BALANCE_FIELDS:
        dense[f][:, 0] = rng.integers(0, 1 << 20, A)
    dense["ledger"] = rng.integers(1, 3, A).astype(np.uint32)
    dense["flags"] = np.zeros(A, np.uint32)
    return dense


@pytest.fixture(scope="module")
def ref_fast(ref_mesh):
    return ref_sharding.make_sharded_commit(ref_mesh, A)


@pytest.mark.parametrize("unsupported", UNSUPPORTED)
def test_grouped_validate_matches_reference(ref_mesh, ref_fast, unsupported):
    """Both dp slices in one grouped call: the codes equal the reference
    mesh's, any routing byte's unsupported bit equals its bail (the
    balances cannot overflow), and each routing byte is the reference's
    ok & pending (1), ok & ~pending (2) or unsupported (8)."""
    rng = np.random.default_rng(sum(map(ord, unsupported)))
    dense = _dense(rng)
    b, host = _ladder_batch(rng, unsupported)
    state = C.state_from_reference(dense, CPU)
    batch = C.TransferBatch(**{k: _t(v) for k, v in b.items()})
    codes, route = S.sharded_validate_grouped(state, batch, _t(host), 0, N)
    assert codes.shape == (N,) and route.shape == (N,) and route.dtype == torch.uint8

    ref_state = ref_commit.LedgerState(**{k: jnp.asarray(v) for k, v in dense.items()})
    ref_b = ref_commit.TransferBatch(**{k: jnp.asarray(v) for k, v in b.items()})
    _, rcodes, rbail = ref_fast(ref_sharding._place(ref_state, ref_mesh), ref_b, jnp.asarray(host))
    np.testing.assert_array_equal(_np(codes), np.asarray(rcodes))
    unsup = (_np(route) & S.M_UNSUPPORTED) != 0
    assert bool(unsup.any()) == bool(rbail) == (unsupported != "none")
    if unsupported == "slice1":
        assert not unsup[:M].any() and unsup[M:].any()

    code, ref_unsup = ref_commit.validate_simple(ref_state, ref_b)
    code = np.asarray(ref_commit.merge_codes(code, jnp.asarray(host)))
    ref_unsup = np.asarray(ref_unsup)
    ok = (code == 0) & ~ref_unsup
    pend = (b["flags"] & C.F_PENDING) != 0
    want = (np.where(ok & pend, E.M_ADD_PEND, 0) | np.where(ok & ~pend, E.M_ADD_POST, 0)
            | np.where(ref_unsup, S.M_UNSUPPORTED, 0)).astype(np.uint8)
    np.testing.assert_array_equal(_np(route), want)


@pytest.mark.parametrize("slices", [1, 2, 4, 8, 33])
def test_grouped_validate_is_its_slices(slices):
    """The gathered layout of a run of slices that follow each other (33
    of them included) is the one-slice plain version's slices in turn,
    the unsupported bit its bail."""
    rng = np.random.default_rng(slices)
    b, host = _ladder_batch(rng, "both")
    state = C.state_from_reference(_dense(rng), CPU)
    batch = C.TransferBatch(**{k: _t(v) for k, v in b.items()})
    m = N // 33
    lo = int(rng.integers(0, N - slices * m + 1))
    codes, route = S.sharded_validate_grouped(state, batch, _t(host), lo, slices * m)
    assert codes.shape == route.shape == (slices * m,)
    for j in range(slices):
        c, r, bail = S.sharded_validate_plain(state, batch, _t(host), lo + j * m, m)
        assert torch.equal(codes[j * m:(j + 1) * m].view(torch.int32), c.view(torch.int32))
        assert torch.equal(route[j * m:(j + 1) * m], r)
        assert bool(bail) == bool(((r & S.M_UNSUPPORTED) != 0).any())


# --- the grouped read ----------------------------------------------------


def _slots(rng, shard):
    rows = A // shard
    edges = [-1, A - 1, A, A + 5, -(1 << 31), 0]
    edges += [s * rows for s in range(shard)] + [s * rows + rows - 1 for s in range(shard)]
    return np.r_[edges, rng.integers(-3, A + 3, 2 * N - len(edges))].astype(np.int32)


@pytest.fixture(scope="module")
def ref_base_read(ref_mesh):
    """The reference's sharded exact base read (make_sharded_commit_exact
    balance_read, :215-231) on its mesh: each shard's owned rows at the
    clipped slots, psum over "shard"."""
    n_shard = ref_mesh.shape["shard"]

    def step(state, rec_slot):
        rows = state.debits_pending.shape[0]
        base_off = jax.lax.axis_index("shard").astype(jnp.int32) * rows
        glob = jnp.clip(rec_slot, 0, A - 1)
        local = glob - base_off
        mine = (local >= 0) & (local < rows)
        lclip = jnp.clip(local, 0, rows - 1)
        stacked = jnp.stack([jnp.where(mine[:, None], getattr(state, f)[lclip], jnp.uint32(0))
                             for f in X.BALANCE_FIELDS])
        return jax.lax.psum(stacked, "shard")

    assert A % n_shard == 0
    return jax.jit(ref_sharding.shard_map(
        step, mesh=ref_mesh, in_specs=(ref_sharding.state_specs(), P()), out_specs=P(),
        check_vma=False))


def test_grouped_read_matches_reference(ref_mesh, ref_base_read):
    """The four shards of a dp row in one grouped call: slots -1, A - 1,
    >= A, the int32 minimum and each shard's first and last row equal the
    reference's dense read_balances and its sharded base read."""
    rng = np.random.default_rng(3)
    dense = _dense(rng)
    slots = _slots(rng, 4)
    mesh = S.make_mesh([CPU] * 8)
    state = S.sharded_state_from_reference(dense, mesh)
    rows = A // 4
    got = S.sharded_read_grouped(list(state.shards[:4]), [s * rows for s in range(4)], _t(slots), A)
    ref_state = ref_commit.LedgerState(**{k: jnp.asarray(v) for k, v in dense.items()})
    dense_read = ref_commit.read_balances(ref_state, jnp.asarray(slots))
    base = np.asarray(ref_base_read(ref_sharding._place(ref_state, ref_mesh), jnp.asarray(slots)))
    for f, g in enumerate(got):
        assert g.shape == (2 * N, 4) and g.dtype == torch.uint32
        np.testing.assert_array_equal(_np(g), np.asarray(dense_read[f]))
        np.testing.assert_array_equal(_np(g), base[f])


@pytest.mark.parametrize("shards", [1, 2, 4, 8, 33])
def test_grouped_read_is_the_or_of_its_shards(shards):
    """Any subset of a row's shards (33 of 33: more than a launch's 32)
    reads each owned row from its owner and zeros elsewhere: the OR of
    the one-shard plain version's blocks."""
    a = 33 * 8
    rows = a // 33
    rng = np.random.default_rng(shards)
    tables = {f: rng.integers(0, 1 << 32, (a, 4), dtype=np.uint64).astype(np.uint32)
              for f in C.BALANCE_FIELDS}
    zero = torch.zeros(a, dtype=torch.int32).view(torch.uint32)
    which = sorted(rng.choice(33, shards, replace=False))
    states = [C.LedgerState(*(_t(tables[f][s * rows:(s + 1) * rows]) for f in C.BALANCE_FIELDS),
                            zero, zero) for s in which]
    bases = [s * rows for s in which]
    slots = _t(np.r_[-1, a - 1, a, rng.integers(-3, a + 3, 200)].astype(np.int32))
    got = S.sharded_read_grouped(states, bases, slots, a)
    want = [torch.zeros((slots.shape[0], 4), dtype=torch.int32) for _ in range(4)]
    for st, base in zip(states, bases):
        for f, blk in enumerate(S.sharded_read_plain(st, slots, base, a)):
            want[f] = want[f] | blk.view(torch.int32)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.view(torch.int32), w)
    if shards == 33:
        whole = np.clip(_np(slots).astype(np.int64), 0, a - 1)
        np.testing.assert_array_equal(_np(got[0]), tables["debits_pending"][whole])


# --- one grouped call a device on the mesh's kernel route ----------------


def _inputs(mesh, seed):
    rng = np.random.default_rng(seed)
    dense = X.state(rng, A)
    b, p, chain, host = X.batch(rng, "config3", N, A)
    fast = {k: v.copy() for k, v in b.items()}
    fast["flags"] &= np.uint32(C.F_PENDING)
    fast["pending_id"][:] = 0
    fast["timeout"][:] = 0
    return (S.sharded_state_from_reference(dense, mesh), C.TransferBatch(**{k: _t(v) for k, v in fast.items()}),
            C.TransferBatch(**{k: _t(v) for k, v in b.items()}), _t(host),
            E.PendingInfo(**{k: _t(v) for k, v in p.items()}), _t(chain))


def _counted(monkeypatch):
    calls = {"validate": [], "read": []}
    validate, read = S.sharded_validate_grouped, S.sharded_read_grouped

    def counted_validate(state, b, host_code, lo, k):
        calls["validate"].append((lo, k))
        return validate(state, b, host_code, lo, k)

    def counted_read(states, bases, slots, a, out=None):
        calls["read"].append(list(bases))
        return read(states, bases, slots, a, out)

    def refused(*args):
        raise AssertionError("the mesh validates and reads through the grouped entries")

    monkeypatch.setattr(S, "sharded_validate_grouped", counted_validate)
    monkeypatch.setattr(S, "sharded_read_grouped", counted_read)
    for name in ("sharded_validate", "sharded_read", "combine_shards"):
        monkeypatch.setattr(S, name, refused)
    return calls


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_commits_validate_and_read_once_a_device(monkeypatch, dp):
    """On make_mesh([cpu] * 8, dp): the fast commit makes one grouped
    validation call (every dp slice, as one range), the exact commit and a
    lookup one grouped read call (dp row 0's shards), none of the one-slice
    or one-shard entries and no combine; results equal the plain mesh
    step's."""
    mesh = S.make_mesh([CPU] * 8, dp=dp)
    rows = A // mesh.shard
    state, fast_b, exact_b, host, pend, chain = _inputs(mesh, 40 + dp)
    zero = torch.zeros(N, dtype=torch.int32).view(torch.uint32)
    calls = _counted(monkeypatch)
    got_f = S.sharded_commit(mesh, A, state, fast_b, zero)
    got_e = S.sharded_commit_exact(mesh, A, state, exact_b, host, pend, chain)
    slots = _t(_slots(np.random.default_rng(dp), mesh.shard))
    got_r = S.read_balances_sharded(mesh, A, state, slots)
    assert calls["validate"] == [(0, N)]
    assert calls["read"] == [[s * rows for s in range(mesh.shard)]] * 2
    monkeypatch.undo()

    want_f = S.sharded_commit_plain(mesh, A, state, fast_b, zero)
    want_e = S.sharded_commit_exact_plain(mesh, A, state, exact_b, host, pend, chain)
    assert torch.equal(got_f[1].view(torch.int32), want_f[1].view(torch.int32))
    assert bool(got_f[2]) == bool(want_f[2])
    for g, w in zip((got_e[1], got_e[2], *got_e[3], *got_e[4]), (want_e[1], want_e[2], *want_e[3], *want_e[4])):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert bool(got_e[5]) == bool(want_e[5])
    for got, want in ((got_f[0], want_f[0]), (got_e[0], want_e[0])):
        gd, wd = S.sharded_state_to_numpy(got, mesh), S.sharded_state_to_numpy(want, mesh)
        for f in wd:
            np.testing.assert_array_equal(gd[f], wd[f], err_msg=f)
    dense = S.sharded_state_to_numpy(state, mesh)
    whole = np.clip(_np(slots).astype(np.int64), 0, A - 1)
    for f, g in zip(C.BALANCE_FIELDS, got_r, strict=True):
        np.testing.assert_array_equal(_np(g), dense[f][whole])


def test_dp_unsupported_bails_through_the_posting():
    """An unsupported flag in dp slice 1 alone reaches the fast commit's
    bail through the routing byte the posting reads, as the reference's
    psum of any(unsupported)."""
    mesh = S.make_mesh([CPU] * 8)
    state, fast_b, *_ = _inputs(mesh, 9)
    flags = fast_b.flags.clone()
    flags[N - 3] |= C.F_LINKED
    b = fast_b._replace(flags=flags)
    zero = torch.zeros(N, dtype=torch.int32).view(torch.uint32)
    assert bool(S.sharded_commit(mesh, A, state, b, zero)[2])
    assert bool(S.sharded_commit_plain(mesh, A, state, b, zero)[2])
    assert not bool(S.sharded_commit(mesh, A, state, fast_b, zero)[2])


# --- the gather over dp ----------------------------------------------------


def test_all_gather_dp_returns_the_batch_tensor():
    """Parts that tile one tensor, in dp order, on the target device give
    that tensor itself (same data_ptr, no copy); out of order, or views of
    two tensors, they are concatenated."""
    x = torch.arange(4 * N, dtype=torch.int32).view(torch.uint32).reshape(N, 4)
    parts = [x[i * M:(i + 1) * M] for i in range(2)]
    got = S.all_gather_dp(parts, [CPU, CPU])
    assert list(got) == [CPU]
    assert got[CPU].data_ptr() == x.data_ptr() and got[CPU].shape == x.shape
    assert torch.equal(got[CPU].view(torch.int32), x.view(torch.int32))
    one = S.all_gather_dp([x[:M]], [CPU])[CPU]
    assert one.data_ptr() == x.data_ptr() and one.shape == (M, 4)
    swapped = S.all_gather_dp(parts[::-1], [CPU])[CPU]
    assert swapped.data_ptr() != x.data_ptr()
    assert torch.equal(swapped.view(torch.int32), torch.cat([parts[1], parts[0]]).view(torch.int32))
    y = x.clone()
    mixed = S.all_gather_dp([x[:M], y[M:]], [CPU])[CPU]
    assert mixed.data_ptr() not in (x.data_ptr(), y.data_ptr())
    assert torch.equal(mixed.view(torch.int32), x.view(torch.int32))
