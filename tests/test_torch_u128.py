"""The port's plain u128 limb functions against the reference's, exact.

Random limbs plus the edges (0, 2^32-1, full carry chains, 2^128-1), made
with numpy from a seed, go through `tigerbeetle_tpu.ops.u128` (JAX on the
CPU) and `tigerbeetle_tpu_torch.ops.u128`; every output must be
byte-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tigerbeetle_tpu.ops import u128 as ref
from tigerbeetle_tpu_torch.ops import u128 as port

MAX32 = 0xFFFFFFFF
A = 64  # scatter table rows


def _limbs(rng, n, w=4):
    """n random (n, w) limb rows with the edge rows appended."""
    r = rng.integers(0, 1 << 32, (n, w), dtype=np.uint64).astype(np.uint32)
    edges = np.array(
        [[0] * w, [MAX32] * w, [MAX32] + [0] * (w - 1), [0] * (w - 1) + [MAX32],
         [MAX32] * (w - 1) + [0], [1] + [0] * (w - 1)],
        dtype=np.uint32,
    )
    r = np.concatenate([r, edges])
    return r[rng.permutation(len(r))]


def _same(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    w = np.asarray(want)
    g = got.numpy()
    assert g.shape == w.shape
    if w.dtype == bool:
        assert g.dtype == np.bool_
        assert np.array_equal(g, w)
    else:
        assert g.dtype == np.uint32
        assert g.tobytes() == w.tobytes()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _case(name, rng):
    """(reference call, port call) on the same numpy inputs."""
    n = 250
    if name in ("add", "sub"):
        a, b = _limbs(rng, n), _limbs(rng, n)
        # full carry/borrow chains
        a[:3] = MAX32
        b[:3] = [[1, 0, 0, 0], [MAX32] * 4, [0, 0, 0, 0]]
        f = getattr(ref, name), getattr(port, name)
        return lambda: f[0](jnp.asarray(a), jnp.asarray(b)), lambda: f[1](_t(a), _t(b))
    if name in ("eq", "lt", "le", "gt", "ge", "min_", "sat_sub", "sum_overflows"):
        a, b = _limbs(rng, n), _limbs(rng, n)
        b[:40] = a[:40]  # equal rows
        b[40:80, 1:] = a[40:80, 1:]  # differing only in the low limb
        f = getattr(ref, name), getattr(port, name)
        return lambda: f[0](jnp.asarray(a), jnp.asarray(b)), lambda: f[1](_t(a), _t(b))
    if name == "select":
        a, b = _limbs(rng, n), _limbs(rng, n)
        pred = rng.random(len(a)) < 0.5
        return (lambda: ref.select(jnp.asarray(pred), jnp.asarray(a), jnp.asarray(b)),
                lambda: port.select(_t(pred), _t(a), _t(b)))
    if name == "widen":  # zero-extension to u160 (`extend` in the port)
        a = _limbs(rng, n)
        return lambda: ref.widen(jnp.asarray(a), 5), lambda: port.extend(_t(a), 5)
    if name == "from_int":
        v = (1 << 127) + (0xDEADBEEF << 40) + 7
        return (lambda: (ref.from_int(v), ref.zeros((3,)), ref.broadcast_to(ref.from_int(v >> 80, 2), (5,))),
                lambda: (port.from_int(v), port.zeros((3,)), port.broadcast_to(port.from_int(v >> 80, 2), (5,))))
    if name in ("is_zero", "is_max"):
        a = _limbs(rng, n)
        f = getattr(ref, name), getattr(port, name)
        return lambda: f[0](jnp.asarray(a)), lambda: f[1](_t(a))
    if name == "mul_u32":
        a = _limbs(rng, n, 1)[:, 0]
        b = _limbs(rng, n, 1)[:, 0]
        return (lambda: ref.mul_u32(jnp.asarray(a), jnp.asarray(b)),
                lambda: port.mul_u32(_t(a), _t(b)))
    if name == "split_u16":
        a = _limbs(rng, n)
        return lambda: ref.split_u16(jnp.asarray(a)), lambda: port.split_u16(_t(a))
    if name == "combine_u16":
        # accumulators up to 2^16 − 1 contributions of ≤ 0xFFFF each
        h = rng.integers(0, 0xFFFE0002, (n, 8), dtype=np.uint64).astype(np.uint32)
        h[:2] = 0xFFFE0001
        return lambda: ref.combine_u16(jnp.asarray(h)), lambda: port.combine_u16(_t(h))
    if name in ("scatter_add", "scatter_sub"):
        table = _limbs(rng, A - 6)
        if name == "scatter_sub":
            table[:, 3] |= 0x80000000  # room to subtract, most rows
        slots = rng.integers(0, A, n).astype(np.int32)
        slots[:40] = 7  # a hot slot
        values = _limbs(rng, n - 6)
        values[:, 3] >>= 6  # sums mostly below 2^128 ...
        values[:4] = MAX32  # ... but the hot slot overflows
        mask = rng.random(n) < 0.8
        f = getattr(ref, name), getattr(port, name)
        return (lambda: f[0](jnp.asarray(table), jnp.asarray(slots),
                             jnp.asarray(values), jnp.asarray(mask)),
                lambda: f[1](_t(table), _t(slots), _t(values), _t(mask)))
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "add", "sub", "is_zero", "is_max", "mul_u32", "split_u16", "combine_u16",
    "scatter_add", "scatter_sub", "eq", "lt", "le", "gt", "ge", "select", "min_",
    "sat_sub", "sum_overflows", "widen", "from_int",
])
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_reference(name, seed):
    want_fn, got_fn = _case(name, np.random.default_rng(seed))
    _same(got_fn(), want_fn())


def test_narrow_widen_round_trip():
    v = _limbs(np.random.default_rng(2), 100)
    assert port.narrow(port.widen(_t(v))).numpy().tobytes() == v.tobytes()
