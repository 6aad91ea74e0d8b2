"""The C-boundary passes: layout parity, ctypes ABI, C bounds absint.

The native datapath rests on hand-kept mirrors:
`csrc/busio.c` hardcodes the 256-byte header and 128-byte Transfer wire
offsets that must equal `vsr/header.py`'s `HEADER_DTYPE` and
`types.TRANSFER_DTYPE`, and `native/__init__.py` hand-declares every
ctypes signature. Any one-sided edit is a silent byte bug until bench
scale. Three passes close the boundary (`python -m
tigerbeetle_tpu_torch.tidy --passes native`):

  - `native-layout` — parse the `#define` constants out of the C sources
    (tidy/cparse.py) and prove them equal to the authoritative Python
    layouts: `HEADER_DTYPE` field offsets/itemsize, the Transfer wire
    dtype, `ReplicaServer.STREAM_LIMIT`, the SoA scan column count, the
    Command/Operation enums. A wrong value is `layout-parity`; a vanished
    constant is `layout-missing`; a NEW `OFF_*`/`T_*`/`CMD_*`/`OP_*`
    define absent from the parity table is `layout-unknown` (one-sided
    additions fail too). The scanned-file set must equal the csrc/ glob
    minus `manifest.NATIVE_C_EXCLUDE` (`unscanned-file`).
  - `native-abi` — parse the C function prototypes and check every
    `argtypes`/`restype` declaration in `native/__init__.py` against them
    (arity, width, signedness, pointer-ness; `c_void_p`/`c_char_p` are
    byte/opaque wildcards). tb_client.h prototypes are cross-checked
    against tb_client.c definitions. Includes the pointer-lifetime lint:
    a `.ctypes.data` address captured from a TEMPORARY (call result) into
    a variable outlives its owner — `ptr-lifetime`; capturing from a
    named array that stays in scope, or passing inline, is fine
    (`.ctypes.data_as` holds a reference and is always fine).
    The same checks cover the CUDA kernels: every entry of
    `ops/kernels.py` SIGNATURES, and every `kernels.helper(...)` binding,
    against the `extern "C"` prototype in its `csrc/<source>.cu`. Only
    those declarations are read (cparse is a C front end: templates,
    `__global__` bodies and `<<<>>>` launches stay out of it); a `.cu`
    declaration it cannot read is `abi-extract`, never a skip.
  - `native-absint` — an unsigned-interval interpreter over a small
    C subset, for `manifest.NATIVE_ABSINT_FUNCS` (the scan /
    gallop / k-way-heap loops): `/* tidy: range= */` entry annotations
    mirror the Python syntax, `bound=name:N` (or `bound=name:param`)
    declares pointer element counts, and every subscript of a bounded
    array must be PROVEN in range — by interval arithmetic with
    branch/loop narrowing, or by a recorded `i < param` guard for
    symbolic bounds. `c-index-bound` when unprovable, `c-parse` when a
    listed function cannot be analyzed (fail closed), `c-bad-annotation`
    for malformed clauses. `analyze_c_function` returns the checked-
    subscript count so tests pin nonzero coverage.

Precision notes (documented, load-bearing): numeric `bound=` values are
allocation FLOORS from the call-site contract (e.g. `bound=out:131072`
because codec.FrameScanner always passes a SCAN_MAX_FRAMES×8 scratch);
the interval domain is non-relational, so invariants it cannot derive are
asserted by `range=` annotations on the governing line, with the reason.
The C sources are shared with the reference package, whose
tools/nativecheck.py --sanitize replays them under ASan and UBSan.
"""

from __future__ import annotations

import ast
import pathlib
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from tigerbeetle_tpu_torch.tidy import annotations as ann_mod
from tigerbeetle_tpu_torch.tidy import cparse, manifest
from tigerbeetle_tpu_torch.tidy.absint import Iv  # the shared interval
from tigerbeetle_tpu_torch.tidy.findings import Finding

_FULL = Iv(-(1 << 64), 1 << 64)
_WIDEN_AFTER = 24
_MAX_ITERS = 64


# =========================================================================
# native-layout
# =========================================================================

def _layout_expectations() -> Dict[str, Dict[str, Tuple[int, str]]]:
    """C file -> {constant name: (expected value, Python truth)}. Imported
    lazily so a run of other passes stays light."""
    from tigerbeetle_tpu_torch import types as wire
    from tigerbeetle_tpu_torch.net import bus, codec
    from tigerbeetle_tpu_torch.vsr import header

    def hoff(f: str) -> int:
        return int(header.HEADER_DTYPE.fields[f][1])

    def toff(f: str) -> int:
        return int(wire.TRANSFER_DTYPE.fields[f][1])

    header_offsets = {
        "OFF_CHECKSUM": ("checksum_lo", hoff("checksum_lo")),
        "OFF_CHECKSUM_BODY": ("checksum_body_lo", hoff("checksum_body_lo")),
        "OFF_PARENT": ("parent_lo", hoff("parent_lo")),
        "OFF_CLIENT": ("client_lo", hoff("client_lo")),
        "OFF_CLUSTER": ("cluster_lo", hoff("cluster_lo")),
        "OFF_SIZE": ("size", hoff("size")),
        "OFF_EPOCH": ("epoch", hoff("epoch")),
        "OFF_VIEW": ("view", hoff("view")),
        "OFF_RELEASE": ("release", hoff("release")),
        "OFF_OP": ("op", hoff("op")),
        "OFF_COMMIT": ("commit", hoff("commit")),
        "OFF_TIMESTAMP": ("timestamp", hoff("timestamp")),
        "OFF_REQUEST": ("request", hoff("request")),
        "OFF_REPLICA": ("replica", hoff("replica")),
        "OFF_COMMAND": ("command", hoff("command")),
        "OFF_OPERATION": ("operation", hoff("operation")),
        "OFF_VERSION": ("version", hoff("version")),
    }
    transfer_offsets = {
        "T_ID": ("id_lo", toff("id_lo")),
        "T_DEBIT": ("debit_account_id_lo", toff("debit_account_id_lo")),
        "T_CREDIT": ("credit_account_id_lo", toff("credit_account_id_lo")),
        "T_AMOUNT": ("amount_lo", toff("amount_lo")),
        "T_PENDING": ("pending_id_lo", toff("pending_id_lo")),
        "T_TIMEOUT": ("timeout", toff("timeout")),
        "T_LEDGER": ("ledger", toff("ledger")),
        "T_CODE": ("code", toff("code")),
        "T_FLAGS": ("flags", toff("flags")),
    }

    def _hdr(names) -> Dict[str, Tuple[int, str]]:
        return {
            c: (v, f"HEADER_DTYPE[{f!r}].offset")
            for c, (f, v) in header_offsets.items() if c in names
        }

    busio = {
        "HEADER_SIZE": (int(header.HEADER_DTYPE.itemsize),
                        "HEADER_DTYPE.itemsize"),
        "CHECKSUM_SIZE": (hoff("checksum_body_lo"),
                          "HEADER_DTYPE['checksum_body_lo'].offset "
                          "(the MAC width is the gap between the two "
                          "checksum fields)"),
        "FRAME_SIZE_MAX": (int(bus.ReplicaServer.STREAM_LIMIT),
                           "net.bus.ReplicaServer.STREAM_LIMIT"),
        "BUSIO_SCAN_COLS": (int(codec.SCAN_COLS), "net.codec.SCAN_COLS"),
    }
    busio.update(_hdr(header_offsets))
    busio.update({
        c: (v, f"TRANSFER_DTYPE[{f!r}].offset")
        for c, (f, v) in transfer_offsets.items()
    })

    tbc = {
        "HEADER_SIZE": (int(header.HEADER_DTYPE.itemsize),
                        "HEADER_DTYPE.itemsize"),
    }
    tbc.update(_hdr((
        "OFF_CHECKSUM", "OFF_CHECKSUM_BODY", "OFF_CLIENT", "OFF_CLUSTER",
        "OFF_SIZE", "OFF_VIEW", "OFF_OP", "OFF_COMMIT", "OFF_TIMESTAMP",
        "OFF_REQUEST", "OFF_REPLICA", "OFF_COMMAND", "OFF_OPERATION",
        "OFF_VERSION",
    )))
    for cmd in ("PING_CLIENT", "PONG_CLIENT", "REQUEST", "REPLY",
                "EVICTION"):
        tbc[f"CMD_{cmd}"] = (int(getattr(header.Command, cmd)),
                             f"vsr.header.Command.{cmd}")
    for op in ("REGISTER", "CREATE_ACCOUNTS", "CREATE_TRANSFERS",
               "LOOKUP_ACCOUNTS", "LOOKUP_TRANSFERS"):
        tbc[f"OP_{op}"] = (int(getattr(header.Operation, op)),
                           f"vsr.header.Operation.{op}")

    return {
        "csrc/busio.c": busio,
        "csrc/hostops.c": {},   # raw byte offsets live in T_*-less memcpys;
        "csrc/aegis128l.c": {},  # no layout constants — ABI-scanned only
        "csrc/tb_client.c": tbc,
        "csrc/tb_client.h": {},
    }


# Prefixes that NAME wire-layout facts: a new define with one of these in
# a scanned file must appear in the parity table above.
_LAYOUT_PREFIXES = ("OFF_", "T_", "CMD_", "OP_")


def check_layout_file(path: pathlib.Path, rel: str,
                      expect: Dict[str, Tuple[int, str]]) -> List[Finding]:
    """Parity findings for ONE C file against its expectation table
    (exposed separately so the fixture tests drive it directly)."""
    out: List[Finding] = []
    try:
        src = path.read_text()
    except OSError as e:
        return [Finding("native-layout", "unscanned-file", rel, 0, "csrc",
                        rel, f"declared C source unreadable: {e}")]
    defines = cparse.parse_defines(src)
    for name, (want, truth) in sorted(expect.items()):
        got = defines.get(name)
        if got is None:
            out.append(Finding(
                "native-layout", "layout-missing", rel, 0, "defines", name,
                f"expected `#define {name}` (= {want}, from {truth}) is "
                "gone — renames must update the parity table in "
                "tidy/nativecheck.py",
            ))
        elif got[0] != want:
            out.append(Finding(
                "native-layout", "layout-parity", rel, got[1], "defines",
                name,
                f"#define {name} is {got[0]} but {truth} says {want} — "
                "the C mirror and the Python layout have diverged",
            ))
    for name, (_val, line) in sorted(defines.items()):
        if name in expect:
            continue
        if any(name.startswith(p) for p in _LAYOUT_PREFIXES):
            out.append(Finding(
                "native-layout", "layout-unknown", rel, line, "defines",
                name,
                f"#define {name} looks like a wire-layout constant but has "
                "no entry in the parity table (tidy/nativecheck.py "
                "_layout_expectations) — add it or rename it",
            ))
    return out


def run_layout(root) -> List[Finding]:
    root = pathlib.Path(root)
    csrc = root / "csrc"
    if not csrc.is_dir():
        return []  # foreign --root: no native layer to check
    findings: List[Finding] = []
    declared = set(manifest.NATIVE_C_SOURCES)
    excluded = set(manifest.NATIVE_C_EXCLUDE)
    present = {
        f"csrc/{p.name}" for p in csrc.iterdir()
        if p.suffix in (".c", ".h", ".cpp", ".hpp", ".cc", ".hh")
    }
    for rel in sorted(present - declared - excluded):
        findings.append(Finding(
            "native-layout", "unscanned-file", rel, 0, "csrc", rel,
            f"{rel} is neither scanned (manifest.NATIVE_C_SOURCES) nor "
            "excluded with a reason (manifest.NATIVE_C_EXCLUDE) — no "
            "silently-unscanned C files",
        ))
    for rel in sorted(declared & excluded):
        findings.append(Finding(
            "native-layout", "unscanned-file", rel, 0, "csrc", rel,
            f"{rel} is both scanned and excluded — pick one",
        ))
    expect = _layout_expectations()
    for rel in manifest.NATIVE_C_SOURCES:
        findings.extend(
            check_layout_file(root / rel, rel, expect.get(rel, {}))
        )
    return findings


# =========================================================================
# native-abi
# =========================================================================

# ABI type lattice: ("void",) | ("int", width, signed) | ("ptr", inner)
# where inner is another ABI type, None (opaque wildcard: c_void_p or a
# named-struct pointer), or ("int", 8, None) (byte wildcard: c_char_p).

_CTYPES_SCALARS = {
    "c_int8": ("int", 8, True), "c_uint8": ("int", 8, False),
    "c_int16": ("int", 16, True), "c_uint16": ("int", 16, False),
    "c_int32": ("int", 32, True), "c_uint32": ("int", 32, False),
    "c_int64": ("int", 64, True), "c_uint64": ("int", 64, False),
    "c_int": ("int", 32, True), "c_uint": ("int", 32, False),
    "c_long": ("int", 64, True), "c_ulong": ("int", 64, False),
    "c_longlong": ("int", 64, True), "c_ulonglong": ("int", 64, False),
    "c_short": ("int", 16, True), "c_ushort": ("int", 16, False),
    "c_size_t": ("int", 64, False), "c_ssize_t": ("int", 64, True),
    "c_byte": ("int", 8, True), "c_ubyte": ("int", 8, False),
    "c_char": ("int", 8, None), "c_bool": ("int", 8, False),
    "c_double": ("float", 64, True), "c_float": ("float", 32, True),
}


def _abi_from_ctype(ct: cparse.CType):
    if ct.ptr > 0:
        inner = _abi_from_ctype(
            cparse.CType(ct.base, ct.width, ct.signed, ct.ptr - 1)
        )
        if inner == ("void",) or (inner and inner[0] == "named"):
            inner = None
        return ("ptr", inner)
    if ct.base == "void":
        return ("void",)
    if ct.base == "int":
        return ("int", ct.width, ct.signed)
    if ct.base == "float":
        return ("float", ct.width, True)
    return ("named", ct.base)


class _PyDeclError(Exception):
    pass


def _resolve_ctypes_expr(node, aliases):
    """AST expression -> ABI type. Raises _PyDeclError on shapes the
    extractor does not understand (reported, never silently skipped)."""
    if node is None or (isinstance(node, ast.Constant) and node.value is None):
        return ("void",)
    if isinstance(node, ast.Name):
        if node.id in aliases:
            return aliases[node.id]
        raise _PyDeclError(f"unknown name {node.id!r}")
    if isinstance(node, ast.Attribute):
        name = node.attr
        if name in _CTYPES_SCALARS:
            return _CTYPES_SCALARS[name]
        if name == "c_void_p":
            return ("ptr", None)
        if name == "c_char_p":
            return ("ptr", ("int", 8, None))
        if name == "c_wchar_p":
            return ("ptr", ("int", 32, None))
        raise _PyDeclError(f"unknown ctypes attribute {name!r}")
    if isinstance(node, ast.Call):
        fn = node.func
        fname = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else "")
        if fname == "POINTER" and len(node.args) == 1:
            return ("ptr", _resolve_ctypes_expr(node.args[0], aliases))
        raise _PyDeclError(f"unsupported call {fname!r}")
    raise _PyDeclError(f"unsupported node {type(node).__name__}")


@dataclass
class PyDecl:
    name: str            # C symbol
    argtypes: Optional[list]
    restype: Optional[tuple]   # None = never assigned (implicit c_int)
    line: int


def _extract_py_decls(tree: ast.Module) -> Tuple[List[PyDecl], List[str]]:
    """Every `<lib>.<sym>.argtypes/.restype = ...` declaration in
    native/__init__.py, following local aliases (`u64p = POINTER(...)`,
    `fn = lib.x`, `for fn in (lib.a, lib.b): ...`, and
    `lib.a.argtypes = lib.b.argtypes`). Returns (decls, errors)."""
    decls: Dict[str, PyDecl] = {}
    errors: List[str] = []

    def sym_of(node, fn_aliases) -> Optional[str]:
        # lib.NAME -> NAME; a Name bound to lib.NAME -> NAME
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            return node.attr
        if isinstance(node, ast.Name):
            return fn_aliases.get(node.id)
        return None

    for fn in [n for n in tree.body if isinstance(n, ast.FunctionDef)]:
        aliases: Dict[str, tuple] = {}
        fn_aliases: Dict[str, object] = {}  # name -> sym str | [syms]
        for node in ast.walk(fn):
            if not isinstance(node, (ast.Assign, ast.For)):
                continue
            if isinstance(node, ast.For):
                # for f in (lib.a, lib.b, ...): f.argtypes = ...
                if (isinstance(node.target, ast.Name)
                        and isinstance(node.iter, (ast.Tuple, ast.List))):
                    syms = [sym_of(e, {}) for e in node.iter.elts]
                    if all(syms):
                        fn_aliases[node.target.id] = syms
                continue
            if len(node.targets) != 1:
                continue
            tgt = node.targets[0]
            # u64p = ctypes.POINTER(...) / fn = lib.aegis128l_mac
            if isinstance(tgt, ast.Name):
                try:
                    aliases[tgt.id] = _resolve_ctypes_expr(
                        node.value, aliases)
                    continue
                except _PyDeclError:
                    pass
                s = sym_of(node.value, fn_aliases)
                if s is not None:
                    fn_aliases[tgt.id] = s
                continue
            if not isinstance(tgt, ast.Attribute):
                continue
            if tgt.attr not in ("argtypes", "restype"):
                continue
            syms = sym_of(tgt.value, fn_aliases)
            if syms is None:
                continue
            if not isinstance(syms, list):
                syms = [syms]
            # RHS: list of types, a single type, or another fn's .argtypes
            for s in syms:
                d = decls.setdefault(s, PyDecl(s, None, None, node.lineno))
                try:
                    if tgt.attr == "restype":
                        d.restype = _resolve_ctypes_expr(node.value, aliases)
                    elif (isinstance(node.value, ast.Attribute)
                          and node.value.attr == "argtypes"):
                        src = sym_of(node.value.value, fn_aliases)
                        if src in decls and decls[src].argtypes is not None:
                            d.argtypes = list(decls[src].argtypes)
                        else:
                            errors.append(
                                f"line {node.lineno}: argtypes aliased from "
                                f"undeclared {src!r}")
                    elif isinstance(node.value, (ast.List, ast.Tuple)):
                        d.argtypes = [
                            _resolve_ctypes_expr(e, aliases)
                            for e in node.value.elts
                        ]
                    else:
                        errors.append(
                            f"line {node.lineno}: argtypes for {s} is not "
                            "a literal list")
                except _PyDeclError as e:
                    errors.append(f"line {node.lineno}: {s}: {e}")
    return list(decls.values()), errors


def _abi_compatible(py, c) -> bool:
    """Python-declared ABI type vs C prototype type."""
    if c[0] == "named":           # bare struct by value: never correct
        return False
    if py == ("void",) or c == ("void",):
        return py == c
    if (py[0] == "ptr") != (c[0] == "ptr"):
        return False
    if py[0] == "ptr":
        pi, ci = py[1], c[1]
        if pi is None or ci is None:   # c_void_p / struct-ptr wildcard
            return True
        if pi[0] == "ptr" or ci[0] == "ptr":
            return (pi[0] == "ptr" and ci[0] == "ptr"
                    and _abi_compatible(("ptr", pi[1]), ("ptr", ci[1])))
        if pi[1] != ci[1]:             # pointee width must match
            return False
        if pi[1] == 8 or pi[2] is None or ci[2] is None:
            return True                # byte buffers: signedness loose
        return pi[2] == ci[2]
    # scalars: exact width + signedness (None = unknown matches)
    if py[0] != c[0] or py[1] != c[1]:
        return False
    return py[2] is None or c[2] is None or py[2] == c[2]


def _fmt_abi(t) -> str:
    if t is None:
        return "void"
    if t == ("ptr", None):
        return "void*"
    if t == ("void",):
        return "void"
    if t[0] == "ptr":
        return _fmt_abi(t[1]) + "*"
    if t[0] == "int":
        s = {True: "int", False: "uint", None: "char"}[t[2]]
        return f"{s}{t[1]}"
    if t[0] == "float":
        return f"float{t[1]}"
    return str(t)


def _c_exports(root: pathlib.Path) -> Tuple[Dict[str, cparse.CFunc],
                                            List[Finding]]:
    """All non-static functions across the scanned C sources, plus
    tb_client.h-vs-.c prototype cross-check findings."""
    exports: Dict[str, cparse.CFunc] = {}
    findings: List[Finding] = []
    protos_h: Dict[str, cparse.CFunc] = {}
    for rel in manifest.NATIVE_C_SOURCES:
        p = root / rel
        if not p.exists():
            continue
        for fn in cparse.parse_functions(p.read_text()):
            if fn.static:
                continue
            if rel.endswith(".h"):
                protos_h[fn.name] = fn
            else:
                exports.setdefault(fn.name, fn)
    for name, proto in sorted(protos_h.items()):
        impl = exports.get(name)
        if impl is None:
            findings.append(Finding(
                "native-abi", "abi-header-mismatch", "csrc/tb_client.h",
                proto.line, "prototypes", name,
                f"{name} is declared in the header but defined in no "
                "scanned C source",
            ))
            continue
        pa = [_abi_from_ctype(p.ctype) for p in proto.params]
        ia = [_abi_from_ctype(p.ctype) for p in impl.params]
        if pa != ia or _abi_from_ctype(proto.ret) != _abi_from_ctype(impl.ret):
            findings.append(Finding(
                "native-abi", "abi-header-mismatch", "csrc/tb_client.h",
                proto.line, "prototypes", name,
                f"header prototype for {name} disagrees with the "
                "definition in tb_client.c",
            ))
    return exports, findings


def check_abi_decls(py_path: pathlib.Path, py_rel: str,
                    exports: Dict[str, cparse.CFunc]) -> List[Finding]:
    """ctypes declarations in `py_path` vs the C prototypes (exposed for
    the fixture tests). An inline `# tidy: allow=<code> reason` on the
    declaration line waives a deliberate mismatch (e.g. a packed-bytes
    parameter block passed as c_char_p for a uint64_t* param)."""
    findings: List[Finding] = []
    src = py_path.read_text()
    anns = ann_mod.collect(src)
    tree = ast.parse(src)
    decls, errors = _extract_py_decls(tree)
    for err in errors:
        findings.append(Finding(
            "native-abi", "abi-extract", py_rel, 0, "module", "ctypes",
            f"could not resolve a ctypes declaration ({err}) — the ABI "
            "check must see every signature",
        ))
    declared = set()
    for d in sorted(decls, key=lambda d: d.line):
        cfn = exports.get(d.name)
        if cfn is None:
            findings.append(Finding(
                "native-abi", "abi-unknown-symbol", py_rel, d.line,
                "ctypes", d.name,
                f"{d.name} has ctypes declarations but no scanned C "
                "source exports it",
            ))
            continue
        declared.add(d.name)
        c_args = [_abi_from_ctype(p.ctype) for p in cfn.params]
        c_ret = _abi_from_ctype(cfn.ret)
        if d.argtypes is not None and len(d.argtypes) != len(c_args):
            findings.append(Finding(
                "native-abi", "abi-arity", py_rel, d.line, "ctypes",
                d.name,
                f"{d.name}: argtypes declares {len(d.argtypes)} args, C "
                f"prototype takes {len(c_args)}",
            ))
        elif d.argtypes is not None:
            for i, (pa, ca) in enumerate(zip(d.argtypes, c_args)):
                if not _abi_compatible(pa, ca):
                    findings.append(Finding(
                        "native-abi", "abi-type", py_rel, d.line, "ctypes",
                        f"{d.name}[{i}]",
                        f"{d.name} arg {i}: Python declares "
                        f"{_fmt_abi(pa)}, C prototype says {_fmt_abi(ca)}",
                    ))
        py_ret = d.restype if d.restype is not None else ("int", 32, True)
        if not _abi_compatible(py_ret, c_ret):
            what = ("restype" if d.restype is not None
                    else "implicit default restype (c_int)")
            findings.append(Finding(
                "native-abi", "abi-restype", py_rel, d.line, "ctypes",
                d.name,
                f"{d.name}: {what} is {_fmt_abi(py_ret)}, C returns "
                f"{_fmt_abi(c_ret)}",
            ))
    for name, cfn in sorted(exports.items()):
        if name not in declared:
            findings.append(Finding(
                "native-abi", "abi-unwrapped", py_rel, 0, "ctypes", name,
                f"C export {name} has no ctypes declaration — wrap it or "
                "make it static",
            ))
    out: List[Finding] = []
    for f in findings:
        a = ann_mod.lookup(anns, f.line) if f.line else None
        if a is not None and (a.allows(f.code) or a.allows("native-abi")):
            continue
        out.append(f)
    return out


_SAFE_OWNERS = (ast.Name, ast.Attribute)


def _lifetime_scan_file(path: pathlib.Path, rel: str) -> List[Finding]:
    try:
        tree = ast.parse(path.read_text())
    except SyntaxError:
        return []
    src_anns = ann_mod.collect(path.read_text())
    findings: List[Finding] = []

    def owner_ok(owner) -> bool:
        # A bare name or attribute chain stays referenced by its binding;
        # a call/subscript result is a temporary the int address outlives.
        node = owner
        while isinstance(node, ast.Attribute):
            node = node.value
        return isinstance(node, ast.Name)

    capture_stmts = (ast.Assign, ast.AnnAssign, ast.AugAssign, ast.Return)
    for stmt in ast.walk(tree):
        if not isinstance(stmt, capture_stmts):
            continue
        value = stmt.value
        if value is None:
            continue
        for node in ast.walk(value):
            if not (isinstance(node, ast.Attribute) and node.attr == "data"):
                continue
            mid = node.value
            if not (isinstance(mid, ast.Attribute) and mid.attr == "ctypes"):
                continue
            if owner_ok(mid.value):
                continue
            line = node.lineno
            a = ann_mod.lookup(src_anns, line)
            if a is not None and (a.allows("ptr-lifetime")
                                  or a.allows("native-abi")):
                continue
            verb = ("returned" if isinstance(stmt, ast.Return)
                    else "captured")
            findings.append(Finding(
                "native-abi", "ptr-lifetime", rel, line, "module",
                ".ctypes.data",
                f"a .ctypes.data address of a temporary is {verb} — the "
                "owning array can be collected before the pointer is "
                "used; bind the array to a name first (or pass the "
                "address inline in the call)",
            ))
    return findings


# --- the CUDA kernels' C interface ------------------------------------------

_EXTERN_C = re.compile(r'extern\s+"C"')
_COMMENTS = re.compile(r"//[^\n]*|/\*.*?\*/", re.DOTALL)


def cu_exports(path: pathlib.Path, rel: str) -> Tuple[Dict[str, cparse.CFunc],
                                                     List[Finding]]:
    """The `extern "C"` functions of one .cu file, parsed from their
    declarations alone: each head (up to its body's `{` or its `;`) is
    copied onto its own lines of an otherwise blank text, which cparse
    reads as C. A declaration it cannot read is a finding."""
    # Comments out (newlines kept, so lines still count true): an
    # `extern "C"` in a comment declares nothing.
    src = _COMMENTS.sub(lambda m: re.sub(r"[^\n]", " ", m.group(0)),
                        path.read_text())
    lines = src.split("\n")
    text = [""] * len(lines)
    heads = []
    for m in _EXTERN_C.finditer(src):
        start, depth, k = m.end(), 0, m.end()
        while k < len(src):
            ch = src[k]
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            elif ch in "{;" and depth == 0:
                break
            k += 1
        line0 = src.count("\n", 0, start)
        head = src[start:k].split("\n")
        for i, part in enumerate(head):
            text[line0 + i] += " " + part
        text[line0 + len(head) - 1] += ";"
        heads.append((line0 + 1, src[start:k].strip()))
    parsed = {
        fn.name: fn for fn in cparse.parse_functions("\n".join(text))
    }
    findings: List[Finding] = []
    by_line = {fn.line: fn for fn in parsed.values()}
    for line, head in heads:
        ok = any(line <= ln < line + head.count("\n") + 1 for ln in by_line)
        if head.startswith("{") or not ok:
            findings.append(Finding(
                "native-abi", "abi-extract", rel, line, "extern-c", rel,
                f"an extern \"C\" declaration of {rel} could not be read "
                f"({head[:60]!r}) — the ABI check must see every entry",
            ))
    return parsed, findings


def _py_abi(node, aliases) -> list:
    """A SIGNATURES argtypes expression -> ABI types: a list of ctypes
    names, `[x] * n`, and `+` of such lists."""
    if isinstance(node, (ast.List, ast.Tuple)):
        return [_py_abi_one(e, aliases) for e in node.elts]
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _py_abi(node.left, aliases) + _py_abi(node.right, aliases)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        lst, cnt = node.left, node.right
        if isinstance(lst, ast.Constant):
            lst, cnt = cnt, lst
        if isinstance(cnt, ast.Constant) and isinstance(cnt.value, int):
            return _py_abi(lst, aliases) * cnt.value
    raise _PyDeclError(f"unsupported argtypes expression {ast.dump(node)[:60]}")


def _py_abi_one(node, aliases):
    """One ctypes type; `kernels._I` resolves through the module's
    aliases by its attribute name."""
    if isinstance(node, ast.Attribute) and node.attr in aliases:
        return aliases[node.attr]
    return _resolve_ctypes_expr(node, aliases)


def _module_aliases(tree: ast.Module) -> Dict[str, tuple]:
    """Module-level `_P = ctypes.c_void_p`-style names."""
    aliases: Dict[str, tuple] = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            try:
                aliases[node.targets[0].id] = _resolve_ctypes_expr(
                    node.value, aliases)
            except _PyDeclError:
                pass
    return aliases


def _literal_dict(tree: ast.Module, name: str):
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        if any(isinstance(t, ast.Name) and t.id == name for t in targets):
            if isinstance(node.value, ast.Dict):
                return node.value
    return None


def _entry_restype(tree: ast.Module, aliases):
    """The restype that `entry()` gives every SIGNATURES entry."""
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == "entry":
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Assign) and len(sub.targets) == 1
                        and isinstance(sub.targets[0], ast.Attribute)
                        and sub.targets[0].attr == "restype"):
                    return _py_abi_one(sub.value, aliases)
    return None


def _cu_decls(py_path: pathlib.Path, helper_paths) -> Tuple[
        List[Tuple[PyDecl, str, pathlib.Path]], List[str]]:
    """(PyDecl, source stem, declaring file) for every SIGNATURES entry
    and every `helper(name, symbol, argtypes, restype)` call."""
    tree = ast.parse(py_path.read_text())
    aliases = _module_aliases(tree)
    errors: List[str] = []
    out: List[Tuple[PyDecl, str, pathlib.Path]] = []
    sig = _literal_dict(tree, "SIGNATURES")
    if sig is None:
        return out, ["no SIGNATURES dict literal"]
    sources: Dict[str, str] = {}
    src_dict = _literal_dict(tree, "SOURCES")
    if src_dict is not None:
        for k, v in zip(src_dict.keys, src_dict.values):
            if isinstance(k, ast.Constant) and isinstance(v, ast.Constant):
                sources[k.value] = v.value
    restype = _entry_restype(tree, aliases)
    if restype is None:
        errors.append("entry() sets no restype")
    for k, v in zip(sig.keys, sig.values):
        try:
            if not (isinstance(k, ast.Constant) and isinstance(v, ast.Tuple)
                    and len(v.elts) == 2
                    and isinstance(v.elts[0], ast.Constant)):
                raise _PyDeclError("entry is not (symbol, argtypes)")
            decl = PyDecl(v.elts[0].value, _py_abi(v.elts[1], aliases),
                          restype, v.lineno)
            out.append((decl, sources.get(k.value, k.value), py_path))
        except _PyDeclError as e:
            errors.append(f"line {v.lineno}: {e}")
    for hp in helper_paths:
        htree = ast.parse(hp.read_text())
        for node in ast.walk(htree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "helper" and len(node.args) == 4):
                continue
            name, sym, args, ret = node.args
            try:
                if not (isinstance(name, ast.Constant)
                        and isinstance(sym, ast.Constant)):
                    raise _PyDeclError("helper name/symbol not literal")
                decl = PyDecl(sym.value, _py_abi(args, aliases),
                              _py_abi_one(ret, aliases), node.lineno)
                stem = sources.get(name.value, name.value)
                out.append((decl, stem, hp))
            except _PyDeclError as e:
                errors.append(f"{hp.name} line {node.lineno}: {e}")
    return out, errors


def check_cu_bindings(py_path: pathlib.Path, py_rel: str,
                      cu_dir: pathlib.Path, root: pathlib.Path,
                      helper_paths=()) -> List[Finding]:
    """SIGNATURES (and helper bindings) in `py_path` against the extern
    "C" prototypes of `cu_dir/<source>.cu` (exposed for the fixture
    tests). Arity, each argument's ABI type and the restype are checked;
    an entry whose symbol its source does not define, and an extern "C"
    function that nothing binds, are findings."""
    root = pathlib.Path(root)
    findings: List[Finding] = []
    decls, errors = _cu_decls(py_path, [pathlib.Path(h) for h in helper_paths])
    for err in errors:
        findings.append(Finding(
            "native-abi", "abi-extract", py_rel, 0, "module", "SIGNATURES",
            f"could not resolve a kernel binding ({err}) — the ABI check "
            "must see every signature",
        ))
    exports: Dict[str, Dict[str, cparse.CFunc]] = {}
    for cu in sorted(cu_dir.glob("*.cu")):
        rel = cu.resolve().relative_to(root.resolve()).as_posix()
        exports[cu.stem], fs = cu_exports(cu, rel)
        findings.extend(fs)
    bound = set()
    for d, stem, where in decls:
        rel = (py_rel if where == py_path else
               where.resolve().relative_to(root.resolve()).as_posix())
        cfn = exports.get(stem, {}).get(d.name)
        if cfn is None:
            findings.append(Finding(
                "native-abi", "abi-unknown-symbol", rel, d.line, "ctypes",
                d.name,
                f"{d.name} is bound but {stem}.cu defines no extern \"C\" "
                "function of that name",
            ))
            continue
        bound.add((stem, d.name))
        c_args = [_abi_from_ctype(p.ctype) for p in cfn.params]
        if len(d.argtypes) != len(c_args):
            findings.append(Finding(
                "native-abi", "abi-arity", rel, d.line, "ctypes", d.name,
                f"{d.name}: argtypes declares {len(d.argtypes)} args, the "
                f"prototype in {stem}.cu takes {len(c_args)}",
            ))
        else:
            for i, (pa, ca) in enumerate(zip(d.argtypes, c_args)):
                if not _abi_compatible(pa, ca):
                    findings.append(Finding(
                        "native-abi", "abi-type", rel, d.line, "ctypes",
                        f"{d.name}[{i}]",
                        f"{d.name} arg {i}: Python declares {_fmt_abi(pa)}, "
                        f"the prototype in {stem}.cu says {_fmt_abi(ca)}",
                    ))
        c_ret = _abi_from_ctype(cfn.ret)
        if d.restype is not None and not _abi_compatible(d.restype, c_ret):
            findings.append(Finding(
                "native-abi", "abi-restype", rel, d.line, "ctypes", d.name,
                f"{d.name}: restype is {_fmt_abi(d.restype)}, the "
                f"prototype in {stem}.cu returns {_fmt_abi(c_ret)}",
            ))
    for stem, fns in sorted(exports.items()):
        for name, cfn in sorted(fns.items()):
            if (stem, name) not in bound:
                findings.append(Finding(
                    "native-abi", "abi-unwrapped", f"{cu_dir.name}/{stem}.cu",
                    cfn.line, "extern-c", name,
                    f"extern \"C\" {name} in {stem}.cu has no binding in "
                    "SIGNATURES or a helper() call",
                ))
    return findings


def run_abi(root) -> List[Finding]:
    root = pathlib.Path(root)
    if not (root / "csrc").is_dir():
        return []
    exports, findings = _c_exports(root)
    py_rel = manifest.NATIVE_PY_BINDINGS
    py_path = root / py_rel
    if py_path.exists():
        findings.extend(check_abi_decls(py_path, py_rel, exports))
    elif exports:
        findings.append(Finding(
            "native-abi", "abi-extract", py_rel, 0, "module", "ctypes",
            "native/__init__.py missing but C sources present",
        ))
    cu_py = root / manifest.NATIVE_CU_BINDINGS
    cu_dir = root / manifest.NATIVE_CU_DIR
    if cu_dir.is_dir():
        findings.extend(check_cu_bindings(
            cu_py, manifest.NATIVE_CU_BINDINGS, cu_dir, root,
            [root / h for h in manifest.NATIVE_CU_HELPER_CALLERS],
        ))
    for d in manifest.NATIVE_LIFETIME_SCAN_DIRS:
        base = root / d
        if not base.is_dir():
            continue
        for p in sorted(base.rglob("*.py")):
            rel = str(p.relative_to(root))
            if rel.startswith("tests/fixtures"):
                continue
            findings.extend(_lifetime_scan_file(p, rel))
    return findings


# =========================================================================
# native-absint: interval interpretation over the C subset
# =========================================================================

@dataclass(frozen=True)
class CV:
    """Scalar: interval + comparison guards proven at this point. A guard
    ("lt", p) records that narrowing established value < param p."""

    iv: Iv
    guards: frozenset = frozenset()


@dataclass(frozen=True)
class PV:
    """Pointer into array `base` (a bounds-table key) at element offset
    `off`; base None = unknown provenance (never checked)."""

    base: Optional[str]
    off: Iv


def _type_iv(ct: cparse.CType) -> Iv:
    if ct.base == "int" and ct.width and not ct.ptr:
        if ct.signed:
            return Iv(-(1 << (ct.width - 1)), (1 << (ct.width - 1)) - 1)
        return Iv(0, (1 << ct.width) - 1)
    return _FULL


def _clamp(lo: int, hi: int) -> Iv:
    return Iv(max(lo, _FULL.lo), min(hi, _FULL.hi))


def _arith(op: str, a: Iv, b: Iv) -> Iv:
    if op == "+":
        return _clamp(a.lo + b.lo, a.hi + b.hi)
    if op == "-":
        return _clamp(a.lo - b.hi, a.hi - b.lo)
    if op == "*":
        cs = [a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi]
        return _clamp(min(cs), max(cs))
    if op == "<<":
        if a.lo >= 0 and 0 <= b.lo and b.hi <= 128:
            return _clamp(a.lo << b.lo, a.hi << b.hi)
        return _FULL
    if op == ">>":
        if a.lo >= 0 and 0 <= b.lo and b.hi <= 512:
            return Iv(a.lo >> b.hi, a.hi >> b.lo)
        return _FULL
    if op == "&":
        if a.lo >= 0 and b.lo >= 0:
            return Iv(0, min(a.hi, b.hi))
        return _FULL
    if op in ("|", "^"):
        if a.lo >= 0 and b.lo >= 0:
            bits = max(a.hi.bit_length(), b.hi.bit_length())
            return Iv(0, (1 << bits) - 1 if bits else 0)
        return _FULL
    if op == "/":
        if b.lo > 0 and a.lo >= 0:
            return Iv(a.lo // b.hi, a.hi // b.lo)
        return _FULL
    if op == "%":
        if b.lo > 0 and a.lo >= 0:
            return Iv(0, b.hi - 1)
        return _FULL
    return Iv(0, 1)  # comparisons / logic


def _same_expr(a, b) -> bool:
    """Structural equality ignoring source lines (min/max ternary)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, cparse.Num):
        return a.v == b.v
    if isinstance(a, cparse.Name):
        return a.n == b.n
    if isinstance(a, cparse.Bin):
        return (a.op == b.op and _same_expr(a.l, b.l)
                and _same_expr(a.r, b.r))
    if isinstance(a, cparse.Un):
        return a.op == b.op and _same_expr(a.e, b.e)
    if isinstance(a, cparse.Idx):
        return _same_expr(a.base, b.base) and _same_expr(a.idx, b.idx)
    if isinstance(a, cparse.Mem):
        return a.f == b.f and _same_expr(a.base, b.base)
    return False


class _Break(Exception):
    pass


class _CFnAnalysis:
    """Interval interpretation of one annotated C function."""

    def __init__(self, rel: str, fn: cparse.CFunc, body: cparse.SBlock,
                 consts: Dict[str, int],
                 anns: Dict[int, ann_mod.LineAnnotations]) -> None:
        self.rel = rel
        self.fn = fn
        self.body = body
        self.consts = consts
        self.anns = anns
        self.findings: List[Finding] = []
        self.checked_ops = 0
        self.bounds: Dict[str, tuple] = {}  # name -> ("num", n)|("sym", p)
        self.param_ptr_depth = {p.name: p.ctype.ptr for p in fn.params}
        self.local_ptr_depth: Dict[str, int] = {}
        self._suppress = False
        self._break_envs: List[list] = []
        self._cont_envs: List[list] = []

    # --- reporting / annotations ---

    def _ann_at(self, line: int):
        return ann_mod.lookup(self.anns, line)

    def _flag(self, code: str, line: int, subject: str, msg: str) -> None:
        if self._suppress:
            return
        for ln in (line, self.fn.line):
            a = self._ann_at(ln)
            if a is not None and (a.allows(code)
                                  or a.allows("native-absint")):
                return
        f = Finding("native-absint", code, self.rel, line,
                    self.fn.name, subject, msg)
        if not any(
            (g.code, g.line, g.subject) == (f.code, f.line, f.subject)
            for g in self.findings
        ):
            self.findings.append(f)

    def _parse_c_ranges(self, a, env: dict) -> Dict[str, CV]:
        """C `range=` clauses: `name:lo..hi` with a numeric hi, or
        `name:lo..<param` asserting BOTH the guard `name < param` and the
        numeric ceiling param.hi - 1 (the heap-content invariants need
        the relational form; the Python grammar stays a strict subset)."""
        out: Dict[str, CV] = {}
        v = a.clauses.get("range")
        if not v:
            return out
        for part in v.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, bounds = part.partition(":")
            name = name.strip()
            lo_s, sep, hi_s = bounds.partition("..")
            if not sep or not name:
                self._flag("c-bad-annotation", a.line, "range",
                           f"range clause {part!r} must be name:lo..hi")
                continue
            hi_s = hi_s.strip()
            try:
                lo = int(lo_s, 0)
            except ValueError:
                self._flag("c-bad-annotation", a.line, "range",
                           f"range lo {lo_s!r} is not an integer")
                continue
            if hi_s.startswith("<"):
                param = hi_s[1:].strip()
                pv = env.get(param)
                if not (param in self.param_ptr_depth
                        and isinstance(pv, CV)):
                    self._flag("c-bad-annotation", a.line, "range",
                               f"range hi {hi_s!r} must name a scalar "
                               "parameter")
                    continue
                out[name] = CV(Iv(lo, pv.iv.hi - 1),
                               frozenset({("lt", param)}))
                continue
            try:
                hi = int(hi_s, 0)
            except ValueError:
                self._flag("c-bad-annotation", a.line, "range",
                           f"range hi {hi_s!r} is not an integer")
                continue
            out[name] = CV(Iv(lo, hi))
        return out

    def _entry_env(self) -> dict:
        env: dict = {}
        a = self._ann_at(self.fn.line)
        ranges: Dict[str, CV] = {}
        if a is not None:
            ranges = self._parse_c_ranges(a, env)
            bclause = a.clauses.get("bound", "")
            for part in bclause.split(","):
                part = part.strip()
                if not part:
                    continue
                name, sep, val = part.partition(":")
                name, val = name.strip(), val.strip()
                if not sep or not name or not val:
                    self._flag("c-bad-annotation", a.line, "bound",
                               f"bound clause {part!r} must be name:N or "
                               "name:param")
                    continue
                folded = cparse._fold_const(val, dict(self.consts))
                if folded is not None:
                    self.bounds[name] = ("num", folded)
                elif val.isidentifier():
                    self.bounds[name] = ("sym", val)
                else:
                    self._flag("c-bad-annotation", a.line, "bound",
                               f"bound value {val!r} is neither a constant "
                               "nor a parameter name")
            for key in a.clauses:
                if key not in cparse.C_KNOWN_KEYS:
                    self._flag("c-bad-annotation", a.line, key,
                               f"unknown tidy annotation key {key!r}")
        for p in self.fn.params:
            if not p.name:
                continue
            if p.ctype.ptr > 0:
                env[p.name] = PV(p.name, Iv(0, 0))
            else:
                env[p.name] = ranges.get(p.name, CV(_type_iv(p.ctype)))
        return env

    # --- env plumbing ---

    @staticmethod
    def _join_val(a, b):
        if isinstance(a, CV) and isinstance(b, CV):
            return CV(a.iv.join(b.iv), a.guards & b.guards)
        if isinstance(a, PV) and isinstance(b, PV) and a.base == b.base:
            return PV(a.base, a.off.join(b.off))
        return CV(_FULL)

    @classmethod
    def _join(cls, a: Optional[dict], b: Optional[dict]) -> Optional[dict]:
        if a is None:
            return None if b is None else dict(b)
        if b is None:
            return dict(a)
        out = {}
        for k in a.keys() & b.keys():
            out[k] = cls._join_val(a[k], b[k])
        return out

    def _set(self, env: dict, name: str, val) -> None:
        """Assignment: the var's own guards die, and so does every guard
        that NAMED this var as its bound (the bound may have moved)."""
        for k, v in list(env.items()):
            if isinstance(v, CV) and any(g[1] == name for g in v.guards):
                env[k] = CV(v.iv, frozenset(
                    g for g in v.guards if g[1] != name))
        env[name] = val

    # --- checks ---

    def _check_index(self, base_name: str, eff: Iv, idx_expr, env: dict,
                     line: int) -> None:
        bound = self.bounds.get(base_name)
        if bound is None:
            return
        self.checked_ops += 1
        if eff.lo < 0:
            self._flag("c-index-bound", line, base_name,
                       f"{base_name}[{eff.lo}..{eff.hi}] may be negative")
            return
        kind, val = bound
        if kind == "num":
            if eff.hi < val:
                return
            self._flag("c-index-bound", line, base_name,
                       f"{base_name}[{eff.lo}..{eff.hi}] may exceed the "
                       f"declared bound {val}")
            return
        # symbolic bound: the index must be a plain variable carrying a
        # `< param` guard established by narrowing on this path
        if isinstance(idx_expr, cparse.Name):
            v = env.get(idx_expr.n)
            if isinstance(v, CV) and ("lt", val) in v.guards:
                return
        self._flag("c-index-bound", line, base_name,
                   f"cannot prove {base_name}[...] stays below its "
                   f"declared bound `{val}` on this path")

    # --- expression evaluation (mutates env for ++/--/assign) ---

    def _eval(self, e, env: dict):
        if isinstance(e, cparse.Num):
            return CV(Iv(e.v, e.v))
        if isinstance(e, cparse.Name):
            if e.n in env:
                return env[e.n]
            if e.n in self.consts:
                v = self.consts[e.n]
                return CV(Iv(v, v))
            return CV(_FULL)
        if isinstance(e, cparse.Bin):
            lv = self._eval(e.l, env)
            rv = self._eval(e.r, env)
            if isinstance(lv, PV) and isinstance(rv, CV) and e.op in "+-":
                off = _arith(e.op, lv.off, rv.iv)
                return PV(lv.base, off)
            if isinstance(rv, PV) and isinstance(lv, CV) and e.op == "+":
                return PV(rv.base, _arith("+", rv.off, lv.iv))
            if isinstance(lv, PV) or isinstance(rv, PV):
                return CV(Iv(0, 1) if e.op in (
                    "==", "!=", "<", ">", "<=", ">=", "&&", "||",
                ) else _FULL)
            return CV(_arith(e.op, lv.iv, rv.iv))
        if isinstance(e, cparse.Un):
            v = self._eval(e.e, env)
            if e.op == "-" and isinstance(v, CV):
                return CV(_clamp(-v.iv.hi, -v.iv.lo))
            if e.op == "!":
                return CV(Iv(0, 1))
            if e.op == "*":
                if isinstance(v, PV) and v.base is not None:
                    self._check_index(v.base, v.off, None, env, e.line)
                return CV(_FULL)
            if e.op == "&":
                return PV(None, Iv(0, 0))  # operand already evaluated above
            return CV(_FULL)
        if isinstance(e, cparse.IncDec):
            if isinstance(e.e, cparse.Name) and e.e.n in env:
                old = env[e.e.n]
                one = Iv(1, 1)
                if isinstance(old, CV):
                    new = CV(_arith("+" if e.op == "++" else "-",
                                    old.iv, one))
                else:
                    new = PV(old.base,
                             _arith("+" if e.op == "++" else "-",
                                    old.off, one))
                self._set(env, e.e.n, new)
                return old if e.post else new
            self._eval(e.e, env)
            return CV(_FULL)
        if isinstance(e, cparse.Call):
            for a in e.args:
                self._eval(a, env)
            return CV(_FULL)
        if isinstance(e, cparse.Idx):
            bv = self._eval(e.base, env)
            iv = self._eval(e.idx, env)
            idx = iv.iv if isinstance(iv, CV) else _FULL
            depth = 0
            if isinstance(e.base, cparse.Name):
                depth = (self.param_ptr_depth.get(e.base.n, 0)
                         or self.local_ptr_depth.get(e.base.n, 0))
            if isinstance(bv, PV) and bv.base is not None:
                eff = _arith("+", bv.off, idx)
                self._check_index(
                    bv.base, eff,
                    e.idx if (bv.off.lo, bv.off.hi) == (0, 0) else None,
                    env, e.line)
            if depth >= 2:
                return PV(None, Iv(0, 0))  # row pointer: unknown array
            return CV(_FULL)
        if isinstance(e, cparse.Mem):
            self._eval(e.base, env)
            return CV(_FULL)
        if isinstance(e, cparse.Cast):
            return self._eval(e.e, env)
        if isinstance(e, cparse.Cond):
            cv_a = self._eval(e.a, dict(env))
            cv_b = self._eval(e.b, dict(env))
            self._eval(e.c, env)
            if isinstance(cv_a, CV) and isinstance(cv_b, CV) and isinstance(
                    e.c, cparse.Bin) and e.c.op in ("<", "<=", ">", ">="):
                a_is_l = _same_expr(e.a, e.c.l) and _same_expr(e.b, e.c.r)
                a_is_r = _same_expr(e.a, e.c.r) and _same_expr(e.b, e.c.l)
                if a_is_l or a_is_r:
                    lt_first = (e.c.op in ("<", "<=")) == a_is_l
                    x, y = cv_a.iv, cv_b.iv
                    if lt_first:   # result = min(a, b)
                        return CV(Iv(min(x.lo, y.lo), min(x.hi, y.hi)))
                    return CV(Iv(max(x.lo, y.lo), max(x.hi, y.hi)))
            if isinstance(cv_a, CV) and isinstance(cv_b, CV):
                return CV(cv_a.iv.join(cv_b.iv))
            return CV(_FULL)
        if isinstance(e, cparse.InitList):
            for it in e.items:
                self._eval(it, env)
            return CV(_FULL)
        if isinstance(e, cparse.Assign):
            return self._assign(e, env)
        return CV(_FULL)

    def _assign(self, e: cparse.Assign, env: dict):
        val = self._eval(e.value, env)
        if e.op != "=":
            cur = self._eval(e.target, dict(env))
            op = e.op[:-1]
            if isinstance(cur, PV) and isinstance(val, CV) and op in "+-":
                val = PV(cur.base, _arith(op, cur.off, val.iv))
            elif isinstance(cur, CV) and isinstance(val, CV):
                val = CV(_arith(op, cur.iv, val.iv))
            else:
                val = CV(_FULL)
        tgt = e.target
        if isinstance(tgt, cparse.Name):
            self._set(env, tgt.n, val)
            # a `range=` annotation on the line asserts a derived bound
            a = self._ann_at(e.line)
            if a is not None and "range" in a.clauses:
                self._apply_ranges(a, env)
        else:
            self._eval(tgt, env)  # store: run the subscript checks
        return val

    def _apply_ranges(self, a, env: dict) -> None:
        for name, cv in self._parse_c_ranges(a, env).items():
            env[name] = cv

    # --- condition narrowing (also runs the checks inside conditions) ---

    @staticmethod
    def _lin(e):
        """e as (name, delta) if e is X, X+c, X-c, or c+X."""
        if isinstance(e, cparse.Name):
            return e.n, 0
        if isinstance(e, cparse.Bin) and isinstance(e.r, cparse.Num):
            if e.op == "+" and isinstance(e.l, cparse.Name):
                return e.l.n, e.r.v
            if e.op == "-" and isinstance(e.l, cparse.Name):
                return e.l.n, -e.r.v
        if (isinstance(e, cparse.Bin) and e.op == "+"
                and isinstance(e.l, cparse.Num)
                and isinstance(e.r, cparse.Name)):
            return e.r.n, e.l.v
        return None, 0

    _NEG = {"<": ">=", "<=": ">", ">": "<=", ">=": "<",
            "==": "!=", "!=": "=="}

    def _cond(self, env: Optional[dict], c, truth: bool) -> Optional[dict]:
        if env is None:
            return None
        if isinstance(c, cparse.Un) and c.op == "!":
            return self._cond(env, c.e, not truth)
        if isinstance(c, cparse.Bin) and c.op == "&&":
            if truth:
                return self._cond(self._cond(env, c.l, True), c.r, True)
            self._eval(c.l, env)  # checks only; ¬(A∧B) narrows nothing
            return env
        if isinstance(c, cparse.Bin) and c.op == "||":
            if not truth:
                return self._cond(self._cond(env, c.l, False), c.r, False)
            self._eval(c.l, env)
            return env
        if isinstance(c, cparse.Bin) and c.op in self._NEG:
            self._eval(c.l, dict(env))
            self._eval(c.r, dict(env))
            op = c.op if truth else self._NEG[c.op]
            env = dict(env)
            env = self._narrow_side(env, c.l, op, c.r)
            if env is None:
                return None
            flipped = {"<": ">", ">": "<", "<=": ">=", ">=": "<=",
                       "==": "==", "!=": "!="}[op]
            return self._narrow_side(env, c.r, flipped, c.l)
        self._eval(c, dict(env))
        return env

    def _narrow_side(self, env: Optional[dict], lhs, op: str,
                     rhs) -> Optional[dict]:
        if env is None:
            return None
        name, d = self._lin(lhs)
        if name is None or not isinstance(env.get(name), CV):
            return env
        rv = self._eval(rhs, dict(env))
        if not isinstance(rv, CV):
            return env
        r = rv.iv
        cur: CV = env[name]
        lo, hi = cur.iv.lo, cur.iv.hi
        guards = set(cur.guards)
        if op == "<":
            hi = min(hi, r.hi - 1 - d)
            if isinstance(rhs, cparse.Name) and d >= 0:
                guards.add(("lt", rhs.n))
        elif op == "<=":
            hi = min(hi, r.hi - d)
            if isinstance(rhs, cparse.Name) and d >= 1:
                guards.add(("lt", rhs.n))
        elif op == ">":
            lo = max(lo, r.lo + 1 - d)
        elif op == ">=":
            lo = max(lo, r.lo - d)
        elif op == "==":
            lo = max(lo, r.lo - d)
            hi = min(hi, r.hi - d)
        elif op == "!=":
            if r.lo == r.hi:
                if r.lo - d == lo:
                    lo += 1
                if r.lo - d == hi:
                    hi -= 1
        if lo > hi:
            return None
        env[name] = CV(Iv(lo, hi), frozenset(guards))
        return env

    # --- statements ---

    def _exec(self, s, env: Optional[dict]) -> Optional[dict]:
        if env is None:
            return None
        if isinstance(s, cparse.SBlock):
            for st in s.stmts:
                env = self._exec(st, env)
                if env is None:
                    return None
            return env
        if isinstance(s, cparse.SDecl):
            for (ct, name, arrsize, init, line) in s.decls:
                if arrsize is not None:
                    self.bounds.setdefault(name, ("num", arrsize))
                    env[name] = PV(name, Iv(0, 0))
                    continue
                if init is not None:
                    v = self._eval(init, env)
                    if ct.ptr > 0 and isinstance(v, CV):
                        v = PV(None, Iv(0, 0))
                else:
                    v = (PV(None, Iv(0, 0)) if ct.ptr > 0
                         else CV(_type_iv(ct)))
                if ct.ptr > 0:
                    self.local_ptr_depth[name] = ct.ptr
                self._set(env, name, v)
                a = self._ann_at(line)
                if a is not None and "range" in a.clauses:
                    self._apply_ranges(a, env)
            return env
        if isinstance(s, cparse.SExpr):
            self._eval(s.e, env)
            if not isinstance(s.e, cparse.Assign):
                a = self._ann_at(s.line)
                if a is not None and "range" in a.clauses:
                    self._apply_ranges(a, env)
            return env
        if isinstance(s, cparse.SRet):
            if s.e is not None:
                self._eval(s.e, env)
            return None
        if isinstance(s, cparse.SBrk):
            self._break_envs[-1].append(dict(env))
            return None
        if isinstance(s, cparse.SCont):
            self._cont_envs[-1].append(dict(env))
            return None
        if isinstance(s, cparse.SIf):
            t_env = self._cond(dict(env), s.c, True)
            e_env = self._cond(dict(env), s.c, False)
            t_out = self._exec(s.t, t_env)
            e_out = self._exec(s.e, e_env) if s.e is not None else e_env
            return self._join(t_out, e_out)
        if isinstance(s, cparse.SWhile):
            return self._loop(env, None, s.c, None, s.body, s.line)
        if isinstance(s, cparse.SFor):
            for st in s.init:
                env = self._exec(st, env)
                if env is None:
                    return None
            return self._loop(env, None, s.c, s.step, s.body, s.line)
        return env

    def _loop(self, env: dict, _unused, cond, steps,
              body, line: int) -> Optional[dict]:
        inv = self._ann_at(line)
        apply_inv = inv is not None and "range" in inv.clauses

        def head(e: Optional[dict]) -> Optional[dict]:
            if e is None:
                return None
            e = dict(e)
            if apply_inv:
                self._apply_ranges(inv, e)
            return e

        def one_pass(cur: dict, report: bool):
            saved = self._suppress
            self._suppress = self._suppress or not report
            self._break_envs.append([])
            self._cont_envs.append([])
            try:
                h = head(cur)
                body_env = (self._cond(h, cond, True)
                            if cond is not None else h)
                out = self._exec(body, body_env)
                conts = self._cont_envs[-1]
                for ce in conts:
                    out = self._join(out, ce)
                if out is not None and steps:
                    for st in steps:
                        out = self._exec(st, out)
                        if out is None:
                            break
                breaks = self._break_envs[-1]
            finally:
                self._break_envs.pop()
                self._cont_envs.pop()
                self._suppress = saved
            return out, breaks

        cur = dict(env)
        prev = None
        for it in range(_MAX_ITERS):
            out, _brk = one_pass(cur, report=False)
            nxt = self._join(cur, out)
            if nxt == cur:
                break
            if it >= _WIDEN_AFTER and prev is not None:
                nxt = self._widen(prev, nxt)
            prev, cur = cur, nxt if nxt is not None else cur
        # Final, reporting pass from the fixed point.
        out, breaks = one_pass(cur, report=True)
        h = head(cur)
        exit_env = (self._cond(h, cond, False)
                    if cond is not None else None)
        for be in breaks:
            exit_env = self._join(exit_env, be)
        return exit_env

    @staticmethod
    def _widen(prev: dict, cur: dict) -> dict:
        out = {}
        for k, v in cur.items():
            pv = prev.get(k)
            if isinstance(v, CV) and isinstance(pv, CV):
                lo = v.iv.lo if v.iv.lo >= pv.iv.lo else _FULL.lo
                hi = v.iv.hi if v.iv.hi <= pv.iv.hi else _FULL.hi
                out[k] = CV(Iv(lo, hi), v.guards)
            elif isinstance(v, PV) and isinstance(pv, PV) and v.base == pv.base:
                lo = v.off.lo if v.off.lo >= pv.off.lo else _FULL.lo
                hi = v.off.hi if v.off.hi <= pv.off.hi else _FULL.hi
                out[k] = PV(v.base, Iv(lo, hi))
            else:
                out[k] = v
        return out

    def run(self) -> None:
        env = self._entry_env()
        self._exec(self.body, env)


def analyze_c_function(path: pathlib.Path, rel: str,
                       fname: str) -> Tuple[List[Finding], int]:
    """(findings, checked subscript count) for one manifest-listed
    function. Parse failure is a c-parse finding — fail closed."""
    try:
        src = path.read_text()
    except OSError as e:
        return ([Finding("native-absint", "c-parse", rel, 0, fname, fname,
                         f"cannot read source: {e}")], 0)
    toks, anns = cparse.lex(src)
    consts = {k: v[0] for k, v in cparse.parse_defines(src).items()}
    typedefs = cparse.collect_typedefs(src)
    fn = next((f for f in cparse.parse_functions(src)
               if f.name == fname and f.body is not None), None)
    if fn is None:
        return ([Finding(
            "native-absint", "c-parse", rel, 0, fname, fname,
            f"manifest-listed function {fname} not found in {rel} — the "
            "C absint must not silently skip it",
        )], 0)
    try:
        body = cparse.parse_body(toks, fn.body, typedefs)
    except cparse.CParseError as e:
        return ([Finding(
            "native-absint", "c-parse", rel, e.line, fname, fname,
            f"body outside the analyzable C subset: {e}",
        )], 0)
    a = _CFnAnalysis(rel, fn, body, consts, anns)
    try:
        a.run()
    except RecursionError:
        return ([Finding("native-absint", "c-parse", rel, fn.line, fname,
                         fname, "analysis diverged (recursion limit)")], 0)
    return a.findings, a.checked_ops


def run_absint(root) -> List[Finding]:
    root = pathlib.Path(root)
    if not (root / "csrc").is_dir():
        return []
    findings: List[Finding] = []
    for rel, fname in manifest.NATIVE_ABSINT_FUNCS:
        fs, _ops = analyze_c_function(root / rel, rel, fname)
        findings.extend(fs)
    return findings
