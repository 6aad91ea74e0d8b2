"""Wide unsigned integer arithmetic on uint32 limb tensors (plain PyTorch).

The port of the reference package's ops/u128.py. u128 (and u64) values
are little-endian uint32 limb tensors: u128 → (..., 4), u64 → (..., 2),
stored as `torch.uint32`, byte-for-byte the reference layout. Overflow
semantics mirror upstream's `sum_overflows` (src/state_machine.zig:1645).

PyTorch's uint32 is a storage type: it has no `+`, `<`, shifts or
`index_put` (on the CPU at least). So every function here widens its limbs
to int64 (`widen`), computes there — a limb sum, a 16-bit partial product
or a sum of up to 2^16 limbs stays far below 2^63 — and narrows the result
back to uint32 (`narrow`). These are the plain versions the CPU runs and
the CUDA kernels (ops/commit.py) are held against.
"""

from __future__ import annotations

import torch

LIMB_MASK = 0xFFFFFFFF


def widen(limbs: torch.Tensor) -> torch.Tensor:
    """uint32 limbs → int64 tensor holding the same values in [0, 2^32)."""
    return limbs.view(torch.int32).to(torch.int64) & LIMB_MASK


def narrow(x: torch.Tensor) -> torch.Tensor:  # tidy: range=x:0..0xFFFFFFFF
    """int64 values in [0, 2^32) → uint32 tensor of the same values (the
    range is a call obligation that tidy/absint checks at every caller)."""
    return (x - ((x >> 31) << 32)).to(torch.int32).view(torch.uint32)


def add(a: torch.Tensor, b: torch.Tensor):
    """(a + b) mod 2^(32W), plus overflow flag. a, b: (..., W) uint32."""
    wa, wb = widen(a), widen(b)
    out = []
    carry = torch.zeros(wa.shape[:-1], dtype=torch.int64, device=a.device)
    for i in range(a.shape[-1]):
        s = wa[..., i] + wb[..., i] + carry
        out.append(s & LIMB_MASK)
        carry = s >> 32
    return narrow(torch.stack(out, dim=-1)), carry != 0


def sub(a: torch.Tensor, b: torch.Tensor):
    """(a - b) mod 2^(32W), plus underflow (borrow) flag."""
    wa, wb = widen(a), widen(b)
    out = []
    borrow = torch.zeros(wa.shape[:-1], dtype=torch.int64, device=a.device)
    for i in range(a.shape[-1]):
        d = wa[..., i] - wb[..., i] - borrow
        borrow = (d < 0).to(torch.int64)
        out.append(d & LIMB_MASK)
    return narrow(torch.stack(out, dim=-1)), borrow != 0


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a.view(torch.int32) == 0).all(dim=-1)


def is_max(a: torch.Tensor) -> torch.Tensor:
    return (a.view(torch.int32) == -1).all(dim=-1)


def mul_u32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full 32x32 → 64-bit product as (..., 2) uint32 limbs (upstream
    state_machine.zig:1326, `timeout * ns_per_s` in u64). 16-bit halves
    keep every partial product below 2^32."""
    wa, wb = widen(a), widen(b)
    al, ah = wa & 0xFFFF, wa >> 16
    bl, bh = wb & 0xFFFF, wb >> 16
    mid = al * bl + ((al * bh + ah * bl) << 16)  # < 2^50
    lo = mid & LIMB_MASK
    hi = (mid >> 32) + ah * bh
    return narrow(torch.stack(torch.broadcast_tensors(lo, hi), dim=-1))


def split_u16(limbs: torch.Tensor) -> torch.Tensor:
    """(..., W) uint32 limbs → (..., 2W) uint32 u16 half-limbs
    [lo0, hi0, lo1, hi1, ...] — the reference's carry-safe accumulation
    format."""
    w = widen(limbs)
    halves = torch.stack([w & 0xFFFF, w >> 16], dim=-1)
    return narrow(halves.reshape(*limbs.shape[:-1], 2 * limbs.shape[-1]))


def combine_u16(halves: torch.Tensor):
    """(..., 2W) uint32 u16-half accumulators → ((..., W) limbs, overflow),
    propagating carries across half-limbs."""
    h = widen(halves)
    out = []
    carry = torch.zeros(h.shape[:-1], dtype=torch.int64, device=halves.device)
    for i in range(halves.shape[-1] // 2):
        lo = h[..., 2 * i] + carry
        carry = lo >> 16
        hi = h[..., 2 * i + 1] + carry
        carry = hi >> 16
        out.append((lo & 0xFFFF) | ((hi & 0xFFFF) << 16))
    return narrow(torch.stack(out, dim=-1)), carry != 0


def _slot_sums(table, slots, values, mask) -> torch.Tensor:
    """(A, W) int64 per-slot sums of the masked `values` limbs. Rows whose
    slot lies outside [0, A) are dropped (the reference's mode="drop").
    Each limb sum is < 2^16 · 2^32, so int64 holds it exactly."""
    a, w = table.shape
    n = slots.shape[0]
    assert n < (1 << 16), "scatter exactness requires n < 2^16"
    keep = mask & (slots >= 0) & (slots < a)
    acc = torch.zeros((a, w), dtype=torch.int64, device=table.device)
    # n < 2^16 rows of limbs < 2^32 each: a slot's sum is < 2^48.
    acc.index_add_(0, slots[keep].to(torch.int64), widen(values)[keep])  # tidy: range=acc:0..0xFFFEFFFF0001
    return acc


def scatter_add(table, slots, values, mask):
    """table (A, W) += values (n, W) at rows `slots` (n,) where mask (n,).

    Exact wide-integer scatter-add: per-slot limb sums, then one carry
    pass adds them to the table. Returns (new_table, overflow (A,)), where
    overflow means the slot's total exceeded the limb width (upstream
    sum_overflows, state_machine.zig:1645); new_table holds the total mod
    2^(32W) either way, as the reference's does."""
    acc = _slot_sums(table, slots, values, mask)
    t = widen(table)
    out = []
    carry = torch.zeros(t.shape[:-1], dtype=torch.int64, device=table.device)
    for i in range(t.shape[-1]):
        s = t[:, i] + acc[:, i] + carry
        out.append(s & LIMB_MASK)
        carry = s >> 32
    return narrow(torch.stack(out, dim=-1)), carry != 0


def scatter_sub(table, slots, values, mask):
    """table (A, W) -= values (n, W) at rows `slots` (n,) where mask (n,).

    Returns (new_table, underflow (A,)): underflow means a slot's removals
    exceeded its balance (or their sum exceeded the limb width, as in the
    reference)."""
    acc = _slot_sums(table, slots, values, mask)
    t = widen(table)
    out = []
    carry = torch.zeros(t.shape[:-1], dtype=torch.int64, device=table.device)
    for i in range(t.shape[-1]):
        s = acc[:, i] + carry
        out.append(s & LIMB_MASK)
        carry = s >> 32
    delta_over = carry != 0
    new_table, under = sub(table, narrow(torch.stack(out, dim=-1)))
    return new_table, under | delta_over


# --- comparisons, selects and widths (the exact route's ladder) -----------


def from_int(value: int, width: int = 4) -> torch.Tensor:
    """Python int → (width,) uint32 limb constant."""
    assert 0 <= value < (1 << (32 * width))
    return narrow(torch.tensor([(value >> (32 * i)) & LIMB_MASK for i in range(width)]))


def zeros(shape, width: int = 4, device=None) -> torch.Tensor:
    return torch.zeros((*shape, width), dtype=torch.int32, device=device).view(torch.uint32)


def broadcast_to(limbs: torch.Tensor, shape) -> torch.Tensor:
    return limbs.expand(*shape, limbs.shape[-1])


def extend(limbs: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-extend (..., W) limbs to (..., width) (the reference's
    `widen(limbs, width)`; here `widen` converts limbs to int64)."""
    have = limbs.shape[-1]
    assert have <= width
    if have == width:
        return limbs
    pad = torch.zeros((*limbs.shape[:-1], width - have), dtype=torch.int32, device=limbs.device)
    return torch.cat([limbs.view(torch.int32), pad], dim=-1).view(torch.uint32)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.view(torch.int32) == b.view(torch.int32)).all(dim=-1)


def lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b, lexicographic from the most significant limb."""
    wa, wb = widen(a), widen(b)
    shape = torch.broadcast_shapes(wa.shape[:-1], wb.shape[:-1])
    less = torch.zeros(shape, dtype=torch.bool, device=a.device)
    equal = torch.ones(shape, dtype=torch.bool, device=a.device)
    for i in reversed(range(a.shape[-1])):
        less = less | (equal & (wa[..., i] < wb[..., i]))
        equal = equal & (wa[..., i] == wb[..., i])
    return less


def le(a, b):
    return ~lt(b, a)


def gt(a, b):
    return lt(b, a)


def ge(a, b):
    return ~lt(a, b)


def select(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise where over limb tensors; pred has shape a.shape[:-1]."""
    a, b = torch.broadcast_tensors(a.view(torch.int32), b.view(torch.int32))
    return torch.where(pred[..., None], a, b).view(torch.uint32)


def min_(a, b):
    return select(lt(a, b), a, b)


def sat_sub(a, b):
    """Saturating a - b (Zig `-|`): 0 on underflow."""
    d, under = sub(a, b)
    return select(under, zeros(d.shape[:-1], d.shape[-1], d.device), d)


def sum_overflows(a, b) -> torch.Tensor:
    """True where a + b overflows the limb width (upstream
    state_machine.zig:1645)."""
    return add(a, b)[1]
