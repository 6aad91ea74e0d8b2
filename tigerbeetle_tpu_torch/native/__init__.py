"""Native (C) host shims, built for this package.

The host runtime around the device kernels uses the repository's C
sources where the reference does: AEGIS-128L checksums (csrc/aegis128l.c,
one AES round per 16 bytes on AES-NI hardware) seal grid blocks, and the
batch host primitives (csrc/hostops.c: u128 hash map, radix argsort,
bloom, the create_transfers staging pass) stage every batch, the
framed-message codec (csrc/busio.c) encodes replies and frames, and the
C client (csrc/tb_client.c, tb_client.h) is the C ABI client library.

Each shim is compiled with the system C compiler on first use into this
package's own build directory (tigerbeetle_tpu_torch/build/, listed in
.gitignore) and loaded via ctypes. Hosts without AES-NI or a C compiler
fall back to BLAKE2b-128 (vsr/header.py) and numpy respectively.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Callable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(os.path.dirname(_PKG), "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
_SRC = os.path.join(_CSRC, "aegis128l.c")

_mac: Optional[Callable[[bytes], bytes]] = None
_tried = False

# The flag set of every shim build: the sources compile warning-free.
_BASE_FLAGS = ("-O3", "-Wall", "-Wextra")


def _build_lib(src: str, name: str, extra_flags: tuple = ()) -> Optional[str]:
    """Compile `src` into BUILD_DIR/lib<name>.<hash>.so and return its
    path, or None without a working C compiler. The hash covers the
    source and the flags, so an edited source is rebuilt and a stale
    library is never loaded."""
    flags = (*_BASE_FLAGS, *extra_flags)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()
    lib = os.path.join(BUILD_DIR, f"lib{name}.{digest[:12]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"  # pid-unique: concurrent first builds
    # must not interleave into one output (os.replace is atomic)
    for cc in ("cc", "gcc", "clang"):
        try:
            r = subprocess.run(
                [cc, *flags, "-shared", "-fPIC", src, "-o", tmp],
                capture_output=True, timeout=120,
            )
        except (OSError, subprocess.TimeoutExpired):
            continue
        if r.returncode == 0:
            os.replace(tmp, lib)
            return lib
    try:
        os.unlink(tmp)
    except OSError:
        pass
    return None


_hostops: Optional[ctypes.CDLL] = None
_hostops_tried = False


def hostops() -> Optional[ctypes.CDLL]:
    """Batch host primitives (csrc/hostops.c): u128 hash map, radix
    argsort, exact u128 posting. Plain C — any host with a compiler."""
    global _hostops, _hostops_tried
    if _hostops_tried:
        return _hostops
    _hostops_tried = True
    src = os.path.join(_CSRC, "hostops.c")
    if not os.path.exists(src):
        return None
    lib_path = _build_lib(src, "hostops")
    if lib_path is None:
        return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError:
        return None
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.hostops_map_new.argtypes = [ctypes.c_uint64]
    lib.hostops_map_new.restype = ctypes.c_void_p
    lib.hostops_map_free.argtypes = [ctypes.c_void_p]
    lib.hostops_map_free.restype = None
    lib.hostops_map_len.argtypes = [ctypes.c_void_p]
    lib.hostops_map_len.restype = ctypes.c_uint64
    lib.hostops_map_insert_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, u64p, u64p, u32p,
    ]
    lib.hostops_map_insert_batch.restype = None
    lib.hostops_map_lookup_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, u64p, u64p, u32p,
    ]
    lib.hostops_map_lookup_batch.restype = None
    lib.hostops_map_contains_any.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, u64p, u64p,
    ]
    lib.hostops_map_contains_any.restype = ctypes.c_int
    lib.hostops_batch_has_dup.argtypes = [ctypes.c_int64, u64p, u64p]
    lib.hostops_batch_has_dup.restype = ctypes.c_int
    lib.hostops_argsort_u64.argtypes = [ctypes.c_int64, u64p, u32p]
    lib.hostops_argsort_u64.restype = ctypes.c_int
    lib.hostops_bloom_add.argtypes = [
        u64p, ctypes.c_uint64, ctypes.c_int64, u64p, u64p,
    ]
    lib.hostops_bloom_add.restype = None
    lib.hostops_bloom_maybe.argtypes = [
        u64p, ctypes.c_uint64, ctypes.c_int64, u64p, u64p, u8p,
    ]
    lib.hostops_bloom_maybe.restype = None
    lib.hostops_post_u128.argtypes = [
        u32p, u32p, u32p, u32p, ctypes.c_int64,
        i64p, i64p, u64p, u64p, u8p, u8p,
    ]
    lib.hostops_post_u128.restype = ctypes.c_int
    lib.hostops_ct_stage.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,  # events, n, stride
        ctypes.c_uint64,                                   # ts_base
        ctypes.c_void_p,                                   # account map
        u32p, u32p,                                        # acc_ledger, acc_flags
        u64p, ctypes.c_uint64,                             # bloom words, mask
        u32p, u32p, i64p, i64p, u64p, u64p, u8p, u8p,
    ]
    lib.hostops_ct_stage.restype = ctypes.c_int
    lib.hostops_build_sorted_kv.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_uint32, ctypes.c_char_p, u32p,
    ]
    lib.hostops_build_sorted_kv.restype = ctypes.c_int
    lib.hostops_extract_kv.argtypes = lib.hostops_build_sorted_kv.argtypes
    lib.hostops_extract_kv.restype = ctypes.c_int
    # Flush sort+gather, k-way merges (plain and with Bloom segments),
    # and the galloping sorted-set intersects.
    lib.hostops_sort_kv.argtypes = [ctypes.c_int64, u64p, u32p, u64p, u32p]
    lib.hostops_sort_kv.restype = ctypes.c_int
    lib.hostops_merge_kv.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64), u64p, u32p,
    ]
    lib.hostops_merge_kv.restype = ctypes.c_int
    lib.hostops_merge_kv_bloom.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64), u64p, u32p,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_void_p), u64p,
    ]
    lib.hostops_merge_kv_bloom.restype = ctypes.c_int
    lib.hostops_intersect_u32.argtypes = [
        ctypes.c_int64, u32p, ctypes.c_int64, u32p, u32p,
    ]
    lib.hostops_intersect_u32.restype = ctypes.c_int64
    lib.hostops_gallop_mark_u32.argtypes = [
        ctypes.c_int64, u32p, ctypes.c_int64, u32p, u8p,
    ]
    lib.hostops_gallop_mark_u32.restype = ctypes.c_int64
    # The C staging ladder hardcodes the wire-contract result codes; refuse
    # the shim (fall back to numpy) if the enums ever drift.
    from tigerbeetle_tpu_torch.results import CreateTransferResult as _TR

    _expect = {
        "TIMESTAMP_MUST_BE_ZERO": 3, "RESERVED_FLAG": 4,
        "ID_MUST_NOT_BE_ZERO": 5, "ID_MUST_NOT_BE_INT_MAX": 6,
        "DEBIT_ACCOUNT_ID_MUST_NOT_BE_ZERO": 8,
        "DEBIT_ACCOUNT_ID_MUST_NOT_BE_INT_MAX": 9,
        "CREDIT_ACCOUNT_ID_MUST_NOT_BE_ZERO": 10,
        "CREDIT_ACCOUNT_ID_MUST_NOT_BE_INT_MAX": 11,
        "ACCOUNTS_MUST_BE_DIFFERENT": 12, "PENDING_ID_MUST_BE_ZERO": 13,
        "TIMEOUT_RESERVED_FOR_PENDING_TRANSFER": 17,
        "AMOUNT_MUST_NOT_BE_ZERO": 18, "LEDGER_MUST_NOT_BE_ZERO": 19,
        "CODE_MUST_NOT_BE_ZERO": 20, "DEBIT_ACCOUNT_NOT_FOUND": 21,
        "CREDIT_ACCOUNT_NOT_FOUND": 22,
        "ACCOUNTS_MUST_HAVE_THE_SAME_LEDGER": 23,
        "TRANSFER_MUST_HAVE_THE_SAME_LEDGER_AS_ACCOUNTS": 24,
        "OVERFLOWS_TIMEOUT": 53,
    }
    for name, val in _expect.items():
        if int(getattr(_TR, name)) != val:
            return None
    _hostops = lib
    return _hostops


def _cpu_has_aes() -> bool:
    import platform

    # x86-only shim (wmmintrin intrinsics); ARM also spells its feature
    # flag "aes", so gate on the architecture first.
    if platform.machine() not in ("x86_64", "amd64", "AMD64"):
        return False
    try:
        with open("/proc/cpuinfo") as f:
            return " aes " in f.read().replace("\n", " ")
    except OSError:
        return False


_lib_built: Optional[str] = None  # the aegis library's path, once built


def aegis128l_mac() -> Optional[Callable[[bytes], bytes]]:
    """Returns bytes -> 16-byte tag, or None if unavailable on this host."""
    global _mac, _tried, _lib_built
    if _tried:
        return _mac
    _tried = True
    if not _cpu_has_aes() or not os.path.exists(_SRC):
        return None
    _lib_built = _build_lib(_SRC, "aegis128l", extra_flags=("-maes", "-mssse3"))
    if _lib_built is None:
        return None
    try:
        lib = ctypes.CDLL(_lib_built)
    except OSError:
        return None
    fn = lib.aegis128l_mac
    fn.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p]
    fn.restype = None

    def mac(data: bytes) -> bytes:
        out = ctypes.create_string_buffer(16)
        fn(data, len(data), out)
        return out.raw

    # Smoke: deterministic and length-sensitive before we trust it.
    a, b = mac(b"x"), mac(b"x")
    if a != b or mac(b"y") == a or mac(b"") == a:
        return None
    _mac = mac
    return _mac



_busio: Optional[ctypes.CDLL] = None
_busio_tried = False


def busio() -> Optional[ctypes.CDLL]:
    """The framed-codec + WAL-ring shim (csrc/busio.c: scan, encode,
    transfer SoA decode, batched pwrite). Frames are sealed with
    AEGIS-128L, so the shim requires AES-NI like the checksum it
    verifies; hosts without it keep the pure-Python encoding
    (net/codec.py)."""
    global _busio, _busio_tried
    if _busio_tried:
        return _busio
    _busio_tried = True
    if not _cpu_has_aes():
        return None
    src = os.path.join(_CSRC, "busio.c")
    if not os.path.exists(src):
        return None
    lib_path = _build_lib(src, "busio", extra_flags=("-maes", "-mssse3"))
    if lib_path is None:
        return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u8pp = ctypes.POINTER(ctypes.c_char_p)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.busio_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, u64p, ctypes.c_int64, u64p,
    ]
    lib.busio_scan.restype = ctypes.c_int64
    # tidy: allow=abi-type — arg 3 (const uint64_t *p) takes codec._ENC_PARAMS.pack's 14-word bytes block; c_char_p marshals it in one conversion
    lib.busio_encode_frame.argtypes = [
        u8p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
    ]
    lib.busio_encode_frame.restype = None
    lib.busio_decode_transfers.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
        i64p, i64p, u32p, u32p, u32p, i32p, i32p,
        u32p, u32p, u32p, u32p, u32p,
    ]
    lib.busio_decode_transfers.restype = None
    lib.busio_pwritev.argtypes = [
        ctypes.c_int32, ctypes.c_int64, u8pp, u64p, u64p,
    ]
    lib.busio_pwritev.restype = ctypes.c_int64
    _busio = lib
    return _busio

_tbclient: Optional[ctypes.CDLL] = None
_tbclient_tried = False


def tb_client() -> Optional[ctypes.CDLL]:
    """The C ABI client library (csrc/tb_client.c + tb_client.h, the role
    of upstream's clients/c/tb_client.zig), built into this package's
    build directory and loaded via ctypes; embedders link it directly.
    Requires AES-NI (the cluster checksum); None where it cannot build."""
    global _tbclient, _tbclient_tried
    if _tbclient_tried:
        return _tbclient
    _tbclient_tried = True
    if not _cpu_has_aes():
        return None
    src = os.path.join(_CSRC, "tb_client.c")
    if not os.path.exists(src):
        return None
    lib_path = _build_lib(src, "tbclient", extra_flags=("-maes", "-mssse3"))
    if lib_path is None:
        return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.tbc_connect.argtypes = [
        ctypes.c_char_p, ctypes.c_uint16, ctypes.c_uint64, ctypes.c_uint32,
    ]
    lib.tbc_connect.restype = ctypes.c_void_p
    lib.tbc_close.argtypes = [ctypes.c_void_p]
    lib.tbc_close.restype = None
    for fn in (
        lib.tbc_create_accounts, lib.tbc_create_transfers,
        lib.tbc_lookup_accounts, lib.tbc_lookup_transfers,
    ):
        fn.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_uint32, u8p, ctypes.c_uint32,
        ]
        fn.restype = ctypes.c_int64
    lib.tbc_demux_results.argtypes = [
        u8p, ctypes.c_uint32, u32p, ctypes.c_uint32, u32p, u32p,
    ]
    lib.tbc_demux_results.restype = ctypes.c_int
    _tbclient = lib
    return _tbclient


def aegis128l_mac_ptr() -> Optional[Callable[[int, int], bytes]]:
    """(address, nbytes) -> 16-byte tag over raw memory — the zero-copy
    sibling of aegis128l_mac for numpy-array bodies."""
    if aegis128l_mac() is None:
        return None
    lib = ctypes.CDLL(_lib_built)
    fn = lib.aegis128l_mac
    fn.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p]
    fn.restype = None

    def mac_ptr(addr: int, size: int) -> bytes:
        out = ctypes.create_string_buffer(16)
        fn(addr, size, out)
        return out.raw

    return mac_ptr
