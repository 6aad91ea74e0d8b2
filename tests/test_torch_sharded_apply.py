"""The mesh's grouped posting (tigerbeetle_tpu_torch/parallel/sharding.py
sharded_apply_grouped) against the reference package's per-shard posting.

One event set goes to every shard of a dp 2 x shard 4 mesh (33 shards in
the chunked case): the port's grouped posting (its plain version, what a
CPU tensor runs) against, for each shard, the reference's posting with
its own masks (parallel/sharding.py :141-156 over ops/commit.py
apply_posting_streamed; with removals, make_sharded_commit_exact's
balance_apply, :233-268, over ops/u128.py). The inputs come from
tests/exact_batches.py apply_group, made with numpy from a seed; every
shard's tables and the group's bail must be equal (tolerance: exact,
integer state). The commits on a virtual mesh make one grouped call a
device: one here, the eight shards of make_mesh([cpu] * 8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tigerbeetle_tpu.ops import commit as ref_commit
from tigerbeetle_tpu.ops import u128 as ref_u128
from tigerbeetle_tpu_torch.ops import commit as C
from tigerbeetle_tpu_torch.ops import commit_exact as E
from tigerbeetle_tpu_torch.parallel import sharding as S

import exact_batches as X

A = 1 << 10
N = 256
CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.view(torch.int32).numpy().view(np.uint32)


def _ref_apply(tables, base, g):
    """The reference's posting into the shard at `base`: (new tables, over)."""
    rows = tables["debits_pending"].shape[0]
    dr, cr = jnp.asarray(g["dr"]), jnp.asarray(g["cr"])
    dl, cl = dr - base, cr - base
    dmine = (dr >= 0) & (dl >= 0) & (dl < rows)
    cmine = (cr >= 0) & (cl >= 0) & (cl < rows)
    m = jnp.asarray(g["mask"])
    pend, post = (m & X.M_ADD_PEND) != 0, (m & X.M_ADD_POST) != 0
    st = ref_commit.LedgerState(**{f: jnp.asarray(v) for f, v in tables.items()},
                                ledger=jnp.zeros(rows, jnp.uint32), flags=jnp.zeros(rows, jnp.uint32))
    amount = jnp.asarray(g["amount"])
    if g["p_amount"] is None:  # make_sharded_commit's posting
        new, over = ref_commit.apply_posting_streamed(
            st, dl, cl, amount, dr_pend=pend & dmine, dr_post=post & dmine,
            cr_pend=pend & cmine, cr_post=post & cmine)
        return {f: np.asarray(getattr(new, f)) for f in X.BALANCE_FIELDS}, bool(over)
    # make_sharded_commit_exact's balance_apply: adds, removals, then the check
    dix, cix = jnp.where(dmine, dl, -1), jnp.where(cmine, cl, -1)
    sub = (m & X.M_SUB_PEND) != 0
    p_amount = jnp.asarray(g["p_amount"])
    new_dp, o1 = ref_u128.scatter_add(st.debits_pending, dix, amount, pend & dmine)
    new_cp, o2 = ref_u128.scatter_add(st.credits_pending, cix, amount, pend & cmine)
    new_dpo, o3 = ref_u128.scatter_add(st.debits_posted, dix, amount, post & dmine)
    new_cpo, o4 = ref_u128.scatter_add(st.credits_posted, cix, amount, post & cmine)
    new_dp, u1 = ref_u128.scatter_sub(new_dp, dix, p_amount, sub & dmine)
    new_cp, u2 = ref_u128.scatter_sub(new_cp, cix, p_amount, sub & cmine)
    o5 = ref_u128.add(new_dp, new_dpo)[1]
    o6 = ref_u128.add(new_cp, new_cpo)[1]
    over = any(bool(jnp.any(o)) for o in (o1, o2, o3, o4, o5, o6, u1, u2))
    new = dict(zip(X.BALANCE_FIELDS, (new_dp, new_dpo, new_cp, new_cpo)))
    return {f: np.asarray(v) for f, v in new.items()}, over


@pytest.mark.parametrize("case", X.APPLY_CASES)
def test_sharded_apply_grouped_matches_reference(case):
    """Every shard's new tables and the group's bail equal the reference's
    per-shard posting; the case's own edge decides the bail (one device's
    overflow bails the group, a cured one does not); the old tables are
    left as they were."""
    g = X.apply_group(np.random.default_rng(sum(map(ord, case))), case, A, N)
    rows = A // 4
    zero = torch.zeros(A, dtype=torch.int32).view(torch.uint32)
    states = [C.LedgerState(*(_t(t[f]) for f in X.BALANCE_FIELDS), zero, zero) for t in g["tables"]]
    ev = [_t(g[k]) if g[k] is not None else None for k in ("dr", "cr", "amount", "p_amount", "mask")]
    new, bail = S.sharded_apply_grouped(states, g["bases"], *ev)
    assert len(new) == len(states) and bail.shape == () and bool(bail) == g["bail"]
    over = False
    for k, (sh, tables, base) in enumerate(zip(new, g["tables"], g["bases"])):
        want, o = _ref_apply(tables, base, g)
        over |= o
        for f in X.BALANCE_FIELDS:
            assert getattr(sh, f).shape == (rows, 4)
            np.testing.assert_array_equal(_np(getattr(sh, f)), want[f], err_msg=f"device {k} {f}")
            np.testing.assert_array_equal(_np(getattr(states[k], f)), tables[f])
    assert bool(bail) == over


def _commit_inputs(mesh, seed):
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


@pytest.mark.parametrize("route", ["fast", "exact"])
def test_commits_post_once_a_device(monkeypatch, route):
    """The mesh's commits on their kernel route (here the kernels' plain
    versions): one sharded_apply_grouped call for each distinct device,
    over every shard it holds (one call of 8 on make_mesh([cpu] * 8)), and
    no one-shard call; the result equals the plain mesh step's."""
    mesh = S.make_mesh([CPU] * 8)
    state, fast_b, exact_b, host, pend, chain = _commit_inputs(mesh, 31)
    calls = []
    grouped, single = S.sharded_apply_grouped, S.sharded_apply

    def counted(states, bases, *args):
        calls.append((len(states), list(bases)))
        return grouped(states, bases, *args)

    def refused(*args):
        raise AssertionError("the mesh posts through the grouped entry")

    monkeypatch.setattr(S, "sharded_apply_grouped", counted)
    monkeypatch.setattr(S, "sharded_apply", refused)
    if route == "fast":
        zero = torch.zeros(N, dtype=torch.int32).view(torch.uint32)
        got = S.sharded_commit(mesh, A, state, fast_b, zero)
        want = S.sharded_commit_plain(mesh, A, state, fast_b, zero)
        outs = [(got[1], want[1])]
        bails = (got[2], want[2])
    else:
        got = S.sharded_commit_exact(mesh, A, state, exact_b, host, pend, chain)
        want = S.sharded_commit_exact_plain(mesh, A, state, exact_b, host, pend, chain)
        outs = list(zip((got[1], got[2], *got[3], *got[4]), (want[1], want[2], *want[3], *want[4])))
        bails = (got[5], want[5])
    assert calls == [(8, [(k % 4) * (A // 4) for k in range(8)])]
    for g, w in outs:
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.uint32 else g,
                           w.view(torch.int32) if w.dtype == torch.uint32 else w)
    assert bool(bails[0]) == bool(bails[1])
    gd, wd = S.sharded_state_to_numpy(got[0], mesh), S.sharded_state_to_numpy(want[0], mesh)
    for f in wd:
        np.testing.assert_array_equal(gd[f], wd[f], err_msg=f)
