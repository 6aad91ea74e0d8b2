"""absint fixture, read in the i64 (signed int64 carrier) mode: one
subtraction that may leave int64 below (one limb-underflow), and the
port's borrow idiom, which stays inside the carrier."""

LIMB_MASK = 0xFFFFFFFF


def unbounded(a, b):  # tidy: range=b:0..0xFFFFFFFF
    return a - b


def borrow(a, b):  # tidy: range=a:0..0xFFFFFFFF,b:0..0xFFFFFFFF
    d = a - b
    return d & LIMB_MASK, d < 0
