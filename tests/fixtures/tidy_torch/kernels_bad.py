"""Fixture: kernel bindings with one wrong argtype and one missing entry
against cu/fx_kernel.cu. tests/test_torch_tidy.py asserts the findings
exactly: edit both together."""

import ctypes

_P = ctypes.c_void_p
_I = ctypes.c_int64

SIGNATURES = {
    "fx_scale": ("tb_fx_scale", [_P, _P, _I, _P]),
    # arg 2 of tb_fx_scale is a long long, not a pointer
    "fx_scale_wide": ("tb_fx_scale", [_P, _P] + [_P] * 2),
    # fx_kernel.cu defines no tb_fx_gone
    "fx_gone": ("tb_fx_gone", [_P, _I, _P]),
}

SOURCES = {"fx_scale": "fx_kernel", "fx_scale_wide": "fx_kernel",
           "fx_gone": "fx_kernel"}


def entry(lib, name):
    fn = getattr(lib, SIGNATURES[name][0])
    fn.argtypes = SIGNATURES[name][1]
    fn.restype = ctypes.c_int
    return fn


def scratch_bytes(kernels, n):
    return kernels.helper("fx_scale", "tb_fx_scratch", [_I], _I)(n)
