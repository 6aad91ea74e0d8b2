"""The port's stable run merge (tigerbeetle_tpu_torch/ops/merge.py) against
the reference package's ops/merge.py, on the CPU.

merge_kernel_tiled's plain version must be byte-equal to the JAX kernel
(jit on the CPU) on the same numpy runs: keys whose high word has its top
bit set (a signed carrier would disorder them), duplicates inside a run
and across both runs (A's rows first), padding rows, and runs shorter
than a tile, at the 256-row tile and a smaller one, and the card kernel's
edge inputs (tests/fold_stacks.py MERGE_EDGES). merge_kernel's must be
byte-equal to the JAX merge_kernel at run lengths that are no tile
multiple, an empty run among them, with flat payloads and payload rows
of 2, 3 and 5 words. The host helpers
(bucket_pow2, to_device_run / from_device_run, merge_device, merge_host,
merge_host_kway) must agree with the reference's too.
"""

import numpy as np
import pytest
import torch

from tigerbeetle_tpu.ops import merge as ref_merge
from tigerbeetle_tpu_torch.lsm.store import KEY_DTYPE, sort_kv
from tigerbeetle_tpu_torch.ops import merge

import fold_stacks


def host_run(rng, n, space, top_bit=False):
    """A lo-major sorted KEY_DTYPE run of n keys drawn from `space` values
    (small: many duplicates), optionally all with bit 63 of lo set."""
    k = np.zeros(n, dtype=KEY_DTYPE)
    lo = rng.integers(0, space, n, dtype=np.uint64)
    if top_bit:
        lo |= np.uint64(1 << 63)
    k["lo"] = np.sort(lo)
    k["hi"] = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    return k, rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


def device_runs(rng, na, nb, space, top_bit):
    """Two padded run-format pairs (numpy), sharing some keys."""
    ka, va = host_run(rng, na, space, top_bit)
    kb, vb = host_run(rng, nb, space, top_bit)
    shared = min(na, nb) // 3
    if shared:  # equal keys across A and B
        kb["lo"][:shared] = ka["lo"][:shared]
        order = np.argsort(kb["lo"], kind="stable")
        kb, vb = kb[order], vb[order]
    return (*merge.to_device_run(ka, va), *merge.to_device_run(kb, vb))


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("tile", [256, 64])
@pytest.mark.parametrize("na,nb,space,top_bit", [
    (512, 768, 1 << 62, True),   # lo1 >= 2^31 everywhere
    (1024, 256, 16, False),      # heavy duplicates inside and across runs
    (5, 37, 1 << 40, False),     # sub-tile runs: padding rows
    (300, 1, 4, True),           # one side a single row, duplicates, top bit
])
def test_merge_kernel_tiled_matches_reference(na, nb, space, top_bit, tile):
    rng = np.random.default_rng(na * 7 + nb)
    runs = device_runs(rng, na, nb, space, top_bit)  # 256-row multiples
    pk, pp = merge.merge_kernel_tiled(*_t(runs), tile=tile)
    rk, rp = ref_merge.merge_kernel_tiled(*runs, tile=tile)
    assert pk.numpy().tobytes() == np.asarray(rk).tobytes()
    assert pp.numpy().tobytes() == np.asarray(rp).tobytes()


@pytest.mark.parametrize("case,n,m,tile", fold_stacks.MERGE_EDGES)
def test_merge_kernel_tiled_edges_match_reference(case, n, m, tile):
    """The card kernel's edge inputs (tests/fold_stacks.py MERGE_EDGES)
    through the plain version and the reference. The reference's tiled
    merge indexes into an empty run, so where one run is empty its global
    merge (ops/merge.py merge_kernel, the same function) stands in."""
    runs = fold_stacks.merge_pair(np.random.default_rng(n + 3 * m), case, n, m)
    pk, pp = merge.merge_kernel_tiled(*_t(runs), tile=tile)
    if n and m:
        rk, rp = ref_merge.merge_kernel_tiled(*runs, tile=tile)
    else:
        rk, rp = ref_merge.merge_kernel(*runs)
    assert pk.numpy().tobytes() == np.asarray(rk).tobytes()
    assert pp.numpy().tobytes() == np.asarray(rp).tobytes()


def raw_runs(rng, na, nb, width, top_bit):
    """Two sorted run-format key blocks of na and nb rows (no padding to
    a tile: a few pad rows [0, 0, 1] end a run of more than 8 rows), keys
    drawn from few values so that they repeat inside and across the runs,
    and random payloads: flat (width None) or (rows, width)."""
    def keys(n):
        lo = np.sort(rng.integers(0, 24, n, dtype=np.uint64))
        if top_bit:
            lo |= np.uint64(1 << 63)
        k = np.zeros((n, 3), np.uint32)
        k[:, 0] = lo & np.uint64(0xFFFFFFFF)
        k[:, 1] = lo >> np.uint64(32)
        if n > 8:
            k[-3:] = [0, 0, 1]
        return k

    def pay(n):
        shape = (n,) if width is None else (n, width)
        return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)

    return keys(na), pay(na), keys(nb), pay(nb)


@pytest.mark.parametrize("width", [None, 2, 3, 5])
@pytest.mark.parametrize("na,nb", [(1, 0), (5, 37), (300, 1), (777, 5), (0, 40)])
def test_merge_kernel_matches_reference(na, nb, width):
    """Any run lengths (no tile multiple, one run empty), top-bit keys on
    odd lengths, flat and wide payloads: the plain version, which the
    card kernel must equal (tests/test_torch_cuda.py), byte-equal to the
    reference's global merge."""
    runs = raw_runs(np.random.default_rng(na * 31 + nb), na, nb, width, top_bit=(na + nb) % 2 == 1)
    pk, pp = merge.merge_kernel(*_t(runs))
    rk, rp = ref_merge.merge_kernel(*runs)
    assert pk.shape == (na + nb, 3) and pp.shape == (na + nb, *runs[1].shape[1:])
    assert pk.numpy().tobytes() == np.asarray(rk).tobytes()
    assert pp.numpy().tobytes() == np.asarray(rp).tobytes()


def test_merge_keeps_a_first_at_equal_keys():
    ka = np.zeros((256, 3), np.uint32)
    ka[:, 1] = 0xFFFFFFFF  # top-bit keys, all equal
    pa = np.zeros((256, 3), np.uint32)
    pa[:, 2] = np.arange(256)
    kb = ka.copy()
    pb = pa.copy()
    pb[:, 2] += 256
    _, pay = merge.merge_kernel_tiled(*_t((ka, pa, kb, pb)))
    assert pay.numpy()[:, 2].tolist() == list(range(512))


def test_merge_kernel_tiled_asserts_tile_multiples():
    k = torch.zeros((100, 3), dtype=torch.uint32)
    with pytest.raises(AssertionError):
        merge.merge_kernel_tiled(k, k, k, k)


def test_bucket_and_padding_match_reference():
    for n in (0, 1, 5, 255, 256, 257, 1000, 40950):
        assert merge.bucket_pow2(n) == ref_merge.bucket_pow2(n)
        assert merge.bucket_pow2(n) % merge.MERGE_TILE == 0
    rng = np.random.default_rng(3)
    for n in (1, 17, 256, 300):
        k, v = host_run(rng, n, 1 << 64)
        for got, want in zip(merge.to_device_run(k, v), ref_merge.to_device_run(k, v)):
            assert got.tobytes() == want.tobytes()
        dk, dv = merge.to_device_run(k, v)
        bk, bv = merge.from_device_run(dk, dv, n)
        rk, rv = ref_merge.from_device_run(dk, dv, n)
        assert bk.tobytes() == rk.tobytes() == k.tobytes()
        assert np.array_equal(bv, rv) and np.array_equal(bv, v)


@pytest.mark.parametrize("na,nb", [(5, 37), (1, 1), (255, 3), (300, 17), (0, 9)])
def test_merge_device_matches_host_merges(na, nb):
    rng = np.random.default_rng(na * 1000 + nb)
    ka, va = host_run(rng, na, 1 << 40, top_bit=nb % 2 == 1)
    kb, vb = host_run(rng, nb, 1 << 40, top_bit=nb % 2 == 1)
    mk, mv = merge.merge_device(ka, va, kb, vb, device="cpu")
    hk, hv = merge.merge_host(ka, va, kb, vb)
    rk, rv = ref_merge.merge_host(ka, va, kb, vb)
    assert mk.tobytes() == hk.tobytes() == rk.tobytes()
    assert np.array_equal(mv, hv) and np.array_equal(hv, rv)
    kk, kv = merge.merge_host_kway([ka, kb], [va, vb])
    assert kk.tobytes() == mk.tobytes() and np.array_equal(kv, mv)


@pytest.mark.parametrize("counts,dups", [
    ((100, 200, 50), False), ((1000,) * 8, True), ((64,) * 20, False),
])
def test_merge_host_kway_matches_radix_and_reference(counts, dups):
    rng = np.random.default_rng(sum(counts))
    parts_k, parts_v = [], []
    for n in counts:
        k, v = host_run(rng, n, 8 if dups else 1 << 50)
        parts_k.append(k)
        parts_v.append(v)
    mk, mv = merge.merge_host_kway(parts_k, parts_v)
    sk, sv = sort_kv(np.concatenate(parts_k), np.concatenate(parts_v))
    rk, rv = ref_merge.merge_host_kway(parts_k, parts_v)
    assert mk.tobytes() == sk.tobytes() == rk.tobytes()
    assert np.array_equal(mv, sv) and np.array_equal(mv, rv)
