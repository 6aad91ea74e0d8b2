"""Cluster scenarios that run unchanged on either package.

The replica parity tests drive the reference package's in-process cluster
(`tigerbeetle_tpu`) and the port's (`tigerbeetle_tpu_torch`) through the
same scenario, on the same seed, and compare what comes out: replies,
lookups, every replica's commit checksum chain and every checkpoint's
trailer section digests. Every function takes the package's name, so
this module imports neither package (nor jax) itself.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import numpy as np

REFERENCE = "tigerbeetle_tpu"
PORT = "tigerbeetle_tpu_torch"

# Cluster arguments that select the state machine's placement: the
# reference's host route, the reference's device route, the port's host
# route and the port's device route (its kernels' plain versions on the
# CPU).
REF_HOST = dict(sm_backend="numpy")
REF_DEVICE = dict(sm_backend="jax")
PORT_HOST = dict(device="cpu")
PORT_DEVICE = dict(device="cpu", device_query_index=True)


def package(pkg: str) -> SimpleNamespace:
    """The names a scenario needs from package `pkg`."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    cluster = mod("testing.cluster")
    clock = mod("vsr.clock")
    hash_log = mod("testing.hash_log")
    return SimpleNamespace(
        Cluster=cluster.Cluster,
        account_batch=cluster.account_batch,
        transfer_batch=cluster.transfer_batch,
        parse_results=cluster.parse_results,
        Operation=mod("vsr.header").Operation,
        types=mod("types"),
        flags=mod("flags"),
        results=mod("results"),
        Clock=clock.Clock,
        DeterministicTime=clock.DeterministicTime,
        HashLog=hash_log.HashLog,
        attach_hash_log=hash_log.attach_to_cluster,
        tidy_runtime=mod("tidy.runtime"),
    )


def setup_client(cl, cid: int = 100):
    c = cl.clients[cid]
    c.register()
    cl.run_until(lambda: c.registered)
    return c


def do_request(cl, c, operation, body, max_ticks: int = 20_000):
    c.request(operation, body)
    cl.run_until(lambda: c.idle, max_ticks)
    return c.replies[-1]


def freeze_time(cl, ns) -> None:
    """Every replica on DeterministicTime(tick_ns=0): prepare timestamps
    then follow the op stream alone, so runs whose reply latency differs
    (serial against a threaded pipeline, host against card) commit the
    same bytes."""
    for r in cl.replicas:
        r.time = ns.DeterministicTime(tick_ns=0)
        r.clock = ns.Clock(r.time, cl.replica_count, r.replica)


def catch_up(cl, max_ticks: int = 60_000) -> None:
    """Run until every live replica reached the highest commit anywhere,
    then drain every stage."""
    target = max(r.commit_min for r in cl.replicas if r is not None)
    cl.run_until(lambda: all(
        r.commit_min >= target for r in cl.replicas if r is not None
    ), max_ticks)
    cl.quiesce()


def transfer_specs(first_id: int, n: int, amount=None, **fields):
    """n transfers from account 1 to 2 with ids from `first_id`; the
    k-th moves `amount`, or k + 1 where none is given."""
    return [
        dict(id=first_id + k, debit_account_id=1, credit_account_id=2,
             amount=1 + k if amount is None else amount, ledger=1, code=1,
             **fields)
        for k in range(n)
    ]


def drive_pipeline(pkg: str, ops: int = 40, hash_log=None, overlap=False,
                   store_async=False, commit_depth=0, **placement):
    """The reference's pipeline determinism workload (3 replicas, seed 9,
    frozen time, `ops` create_transfers batches of 4 past two TEST_MIN
    checkpoints), with the runtime affinity and lock-order audit on.
    Returns (chains, floors, checkpoint digests, reply bodies)."""
    ns = package(pkg)
    ns.tidy_runtime.enable()
    cl = ns.Cluster(
        replica_count=3, seed=9, overlap=overlap, store_async=store_async,
        commit_depth=commit_depth, **placement,
    )
    freeze_time(cl, ns)
    if hash_log is not None:
        ns.attach_hash_log(cl, hash_log)
    try:
        c = setup_client(cl)
        replies = [bytes(do_request(
            cl, c, ns.Operation.CREATE_ACCOUNTS, ns.account_batch([1, 2])
        ).body)]
        for i in range(ops):
            replies.append(bytes(do_request(
                cl, c, ns.Operation.CREATE_TRANSFERS,
                ns.transfer_batch(transfer_specs(1 + i * 4, 4)),
            ).body))
        catch_up(cl)
        if overlap:
            assert all(r.executor is not None for r in cl.replicas)
        if store_async:
            assert all(r.store_executor is not None for r in cl.replicas)
        chains = [dict(r.commit_checksums) for r in cl.replicas]
        floors = [r.checksum_floor for r in cl.replicas]
        assert cl.check_state_convergence() > 0
        assert cl.check_storage_convergence() >= cl.config.checkpoint_interval
        return chains, floors, dict(cl._checkpoint_history), replies
    finally:
        cl.close()
        ns.tidy_runtime.disable()


def check_runs_identical(want_ops: int, base, *others,
                         checkpoint_interval: int = 16) -> None:
    """Every commit checksum recorded by any replica of any run agrees op
    for op; every replica carries a contiguous chain from its floor to
    the workload's last op; every checkpoint both runs reached has the
    same trailer section digests; the replies are the same bytes."""
    ref: dict = {}
    runs = (base, *others)
    for chains, _floors, _hist, _replies in runs:
        for c in chains:
            for op, v in c.items():
                assert ref.setdefault(op, v) == v, (
                    f"divergent commit checksum at op {op}"
                )
    for ix, (chains, floors, _hist, _replies) in enumerate(runs):
        for c, f in zip(chains, floors):
            assert c and max(c) >= want_ops, f"run {ix}: replica tail lags"
            missing = set(range(f + 1, max(c) + 1)) - set(c)
            assert not missing, f"run {ix}: chain holes {sorted(missing)[:8]}"
        assert any(f == 0 for f in floors), f"run {ix}: no complete chain"
    for _chains, _floors, hist, replies in others:
        common = set(base[2]) & set(hist)
        assert common and max(common) >= checkpoint_interval
        for op in common:
            assert base[2][op] == hist[op], (
                f"checkpoint {op}: trailer digests differ"
            )
        assert replies == base[3]


def u128_column(recs, types_mod, field: str):
    return [types_mod.u128_of(r, field) for r in recs]


def lookup_ids(types_mod, ids) -> bytes:
    arr = np.zeros(len(ids), dtype=types_mod.ID_DTYPE)
    arr["lo"] = ids
    return arr.tobytes()
