"""The 128-bit checksum that seals grid blocks (slim copy of the
reference package's vsr/header.py: `checksum` and what it needs).

Like the reference (vsr/checksum.zig:1-45), the MAC is AEGIS-128L with a
zero key — via the native AES-NI shim (native/, csrc/aegis128l.c). Hosts
without the shim use BLAKE2b-128. The two are format-incompatible, but in
this port blocks live only in the in-memory grid of one process, so no
block ever crosses hosts. The choice is made at the first checksum, not
at import, so importing the package builds nothing.
"""

from __future__ import annotations

import hashlib

import numpy as np

CHECKSUM_SIZE = 16

_checksum_fn = None
CHECKSUM_ALGORITHM = None


def _blake2b(data) -> int:
    return int.from_bytes(
        hashlib.blake2b(bytes(data), digest_size=16).digest(), "little"
    )


def _select_checksum():
    """aegis128l when the native shim loads, else blake2b."""
    from tigerbeetle_tpu_torch import native

    mac = native.aegis128l_mac()
    if mac is None:
        return _blake2b, "blake2b"
    mac_ptr = native.aegis128l_mac_ptr()

    def _cs(data):
        if (
            mac_ptr is not None
            and isinstance(data, np.ndarray)
            and data.flags["C_CONTIGUOUS"]
        ):
            # MAC straight over the array memory; strided views take the
            # copying path (ctypes.data walks raw memory).
            return int.from_bytes(mac_ptr(data.ctypes.data, data.nbytes), "little")
        return int.from_bytes(mac(bytes(data)), "little")

    return _cs, "aegis128l"


def checksum(data) -> int:
    """128-bit MAC over grid blocks."""
    global _checksum_fn, CHECKSUM_ALGORITHM
    if _checksum_fn is None:
        _checksum_fn, CHECKSUM_ALGORITHM = _select_checksum()
    return _checksum_fn(data)
