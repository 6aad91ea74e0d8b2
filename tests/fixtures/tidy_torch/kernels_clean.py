"""Fixture: the clean twin of kernels_bad.py: every entry of
cu/fx_kernel.cu bound with its prototype's types."""

import ctypes

_P = ctypes.c_void_p
_I = ctypes.c_int64

SIGNATURES = {
    "fx_scale": ("tb_fx_scale", [_P] * 2 + [_I, _P]),
}

SOURCES = {"fx_scale": "fx_kernel"}


def entry(lib, name):
    fn = getattr(lib, SIGNATURES[name][0])
    fn.argtypes = SIGNATURES[name][1]
    fn.restype = ctypes.c_int
    return fn


def scratch_bytes(kernels, n):
    return kernels.helper("fx_scale", "tb_fx_scratch", [_I], _I)(n)
