"""Interval abstract interpretation over the port's limb arithmetic.

The u128/fold56 code paths do wide-integer math on narrow machine words,
where a silent wrap is not an exception: it is a wrong balance that
replicates itself into every checkpoint. This pass PROVES, per arithmetic
operation, that the result stays within its width, from annotated entry
ranges (the reference package's tidy/absint.py, with a second mode and a
second front end for where the port keeps its arithmetic).

  - Domain: integer intervals [lo, hi] per value, with a `host` flag for
    Python-int/shape/index values (arbitrary precision, exempt from width
    checks). Function parameters default to the full range of the mode;
    `# tidy: range=name:lo..hi` on the def line narrows them (the
    documented input contract, machine-read). The same annotation on an
    assignment or expression line asserts a bound the analysis cannot
    derive (a scatter-accumulation whose count bound lives in an
    `assert`; the annotation carries the reason).
  - Transfer functions: exact interval arithmetic for + - * << >> & | ^
    % //, bit-length bounds for the bitwise ops, hulls for where/select/
    stack/cat, [0, 1] for comparisons, fixed-point iteration (bounded,
    with widening) for loop-carried carries.
  - Checks: `limb-overflow` when + * << may exceed the width,
    `limb-underflow` when - may go below it, `range-obligation` when a
    call argument may exceed the callee's declared `range=`. Intentional
    wraps carry `# tidy: allow=limb-overflow reason`: explicit, never
    silent.

Modes (manifest.ABSINT_TARGETS names each target's):

  - `u32` / `u64`: unsigned words of that width, the reference's domain.
    `lsm/scan.py` (numpy uint64, the fold56 key build) is read at 64 bits,
    as in the reference. `ops/qindex.py` carries uint32 words in int64
    tensors, and every value there must stay a uint32 word for the key
    block to narrow back exactly, so it is read at 32 bits: the proof
    that every shift and OR stays inside 32 bits is the reference's.
  - `i64`: the signed int64 carrier of `ops/u128.py`. The port's plain
    u128 widens each uint32 limb into an int64 and takes its borrow from
    `d < 0`, so a limb difference is meant to go negative. Here the proof
    is that every value stays within int64 (an add, a product or a shift
    that may leave [-2^63, 2^63) is a finding) and that each
    `& LIMB_MASK` lands in [0, 2^32) (an AND with a non-negative mask is
    non-negative, whatever the sign of the other side). `.to(dtype)`
    passes its interval through; `.view(dtype)` reinterprets bits, so its
    value is the full range; an in-place method (`acc.index_add_(...)`)
    leaves its receiver at the full range unless a line `range=` says
    more.

The CUDA front end (`prove_cuda_function`) reads the device helpers where
the port's carries now live (manifest.ABSINT_CUDA_FUNCS) through
tidy/cparse.py, the C front end of `native-absint`. Each value carries its
C type: widths and signedness come from the declarations (`uint32_t`,
`unsigned long long`, `u128` = `unsigned __int128`, `uint2` / `uint4`
members, struct fields, `constexpr` constants), the usual arithmetic
conversions pick each operation's type, and an operation whose exact
result may leave that type's range is a finding with the same codes. An
implicit conversion that may truncate (an assignment or initialisation
into a narrower type) is a `limb-overflow` too; an explicit cast is the
source saying so. Atomics return an opaque value at the full width of
their pointee. Calls to helpers of the same file are summarised at the
callee's declared ranges (its return value and its reference
parameters' final values), and their `range=` are call obligations.
Annotations are `/* tidy: range=... */` and `// tidy: allow=...`, the
grammar `native-absint` reads. A loop is outside this front end (no
listed helper has one): a listed function with a loop is a `c-parse`
finding, never a silent pass.

`prove_file` and `prove_cuda_function` return the checked-operation count
so the tests can see that the interpreter visited the arithmetic instead
of skipping it.
"""

from __future__ import annotations

import ast
import pathlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from tigerbeetle_tpu_torch.tidy import annotations as ann_mod
from tigerbeetle_tpu_torch.tidy import cparse, manifest
from tigerbeetle_tpu_torch.tidy.findings import Finding

_WIDEN_AFTER = 64  # fixed-point iterations before widening to TOP


@dataclass(frozen=True)
class Iv:
    """Closed integer interval. `host` marks Python-int/shape/index
    values (no wrap semantics)."""

    lo: int
    hi: int
    host: bool = False

    def join(self, other: "Iv") -> "Iv":
        return Iv(min(self.lo, other.lo), max(self.hi, other.hi),
                  self.host and other.host)


BOOL = Iv(0, 1)
HOST_TOP = Iv(0, 1 << 200, host=True)

MODES = {"u32": (32, False), "u64": (64, False), "i64": (64, True)}


def _bitlen_bound(a: Iv, b: Iv) -> Iv:
    bits = max(a.hi.bit_length(), b.hi.bit_length())
    return Iv(0, (1 << bits) - 1 if bits else 0)


def parse_ranges(ann) -> Dict[str, Iv]:
    """`range=a:0..0xFF,b:10..20` -> {name: Iv}. Malformed clauses raise
    ValueError (reported as a bad-range finding by the caller)."""
    out: Dict[str, Iv] = {}
    v = ann.clauses.get("range")
    if not v:
        return out
    for part in v.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, bounds = part.partition(":")
        lo_s, sep, hi_s = bounds.partition("..")
        if not sep:
            raise ValueError(f"range clause {part!r} must be name:lo..hi")
        out[name.strip()] = Iv(int(lo_s, 0), int(hi_s, 0))
    return out


# =========================================================================
# The Python front end
# =========================================================================


class _FnAnalysis:
    """One function body interpreted over one width domain."""

    def __init__(self, owner: "_FileAnalysis", fn: ast.FunctionDef,
                 scope: str) -> None:
        self.o = owner
        self.fn = fn
        self.scope = scope
        self.width = owner.width
        self.signed = owner.signed
        if self.signed:
            self.min = -(1 << (self.width - 1))
            self.max = (1 << (self.width - 1)) - 1
        else:
            self.min = 0
            self.max = (1 << self.width) - 1
        self.env: Dict[str, object] = {}  # name -> Iv | list[Iv] | tuple
        self.findings: List[Finding] = []
        self.checked_ops = 0
        self.return_iv: Optional[object] = None
        self._suppress_reports = False

    def _top(self) -> Iv:
        return Iv(self.min, self.max)

    # --- reporting ---------------------------------------------------------

    def _flag(self, code: str, line: int, subject: str, message: str) -> None:
        if self._suppress_reports:
            return
        for ln in (line, self.fn.lineno):
            a = ann_mod.lookup(self.o.anns, ln)
            if a is not None and (a.allows(code) or a.allows("absint")):
                return
        self.findings.append(Finding(
            "absint", code, self.o.rel, line, self.scope, subject, message,
        ))

    # --- entry -------------------------------------------------------------

    def run(self) -> None:
        declared: Dict[str, Iv] = {}
        a = ann_mod.lookup(self.o.anns, self.fn.lineno)
        if a is not None and "range" in a:
            try:
                declared = parse_ranges(a)
            except ValueError as e:
                self._flag("bad-range", self.fn.lineno, "range", str(e))
        args = self.fn.args
        for p in (
            list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
        ):
            if p.arg in declared:  # declared range wins over the type hint
                self.env[p.arg] = declared[p.arg]
            elif (
                isinstance(p.annotation, ast.Name)
                and p.annotation.id == "int"
            ):
                # `: int`-hinted params are Python ints: arbitrary
                # precision, exempt from machine-width checks until they
                # pass through a machine-word constructor.
                self.env[p.arg] = HOST_TOP
            else:
                self.env[p.arg] = self._top()
        if args.vararg:
            self.env[args.vararg.arg] = self._top()
        self.o.declared_ranges[self.scope] = declared
        self._exec_block(self.fn.body)

    # --- statements --------------------------------------------------------

    def _exec_block(self, body) -> None:
        for stmt in body:
            self._exec(stmt)

    def _bind(self, target, val) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = val
        elif isinstance(target, (ast.Tuple, ast.List)):
            vals = (
                list(val) if isinstance(val, (list, tuple))
                and len(val) == len(target.elts)
                else [self._as_iv(val)] * len(target.elts)
            )
            for t, v in zip(target.elts, vals):
                self._bind(t, v)

    def _apply_line_range(self, stmt) -> Dict[str, Iv]:
        a = ann_mod.lookup(self.o.anns, stmt.lineno)
        if a is None or "range" not in a:
            return {}
        try:
            return parse_ranges(a)
        except ValueError as e:
            self._flag("bad-range", stmt.lineno, "range", str(e))
            return {}

    def _exec(self, stmt) -> None:
        if isinstance(stmt, ast.Assign):
            val = self.eval(stmt.value)
            for t in stmt.targets:
                self._bind(t, val)
            for name, iv in self._apply_line_range(stmt).items():
                self.env[name] = iv  # declared assumption overrides
        elif isinstance(stmt, ast.AugAssign):
            cur = self.eval(stmt.target) if isinstance(stmt.target, ast.Name) \
                else self._top()
            rhs = self.eval(stmt.value)
            val = self._binop(stmt.op, self._as_iv(cur), self._as_iv(rhs),
                              stmt.lineno)
            self._bind(stmt.target, val)
            for name, iv in self._apply_line_range(stmt).items():
                self.env[name] = iv
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            val = self.eval(stmt.value)
            if _is_int_hint(stmt.annotation):
                # `n: int = ...` names a Python int (a size or an index):
                # arbitrary precision, as a `: int` parameter is.
                iv = self._as_iv(val)
                val = Iv(iv.lo, iv.hi, host=True) if iv.host else HOST_TOP
            self._bind(stmt.target, val)
        elif isinstance(stmt, ast.Return):
            val = self.eval(stmt.value) if stmt.value is not None else Iv(0, 0)
            self.return_iv = (
                val if self.return_iv is None
                else self._join_any(self.return_iv, val)
            )
        elif isinstance(stmt, ast.If):
            self.eval(stmt.test)  # condition arithmetic is checked too
            before = dict(self.env)
            self._exec_block(stmt.body)
            after_then = self.env
            self.env = before
            self._exec_block(stmt.orelse)
            self.env = self._join_env(after_then, self.env)
        elif isinstance(stmt, ast.For):
            self._bind(stmt.target, self._iter_iv(stmt.iter))
            self._fixpoint(stmt.body)
        elif isinstance(stmt, ast.While):
            self.eval(stmt.test)
            self._fixpoint(stmt.body)
        elif isinstance(stmt, ast.Expr):
            self.eval(stmt.value)
            # An in-place update's bound (`acc.index_add_(...)`).
            for name, iv in self._apply_line_range(stmt).items():
                self.env[name] = iv
        elif isinstance(stmt, ast.Assert):
            self.eval(stmt.test)
        elif isinstance(stmt, (ast.Try,)):
            self._exec_block(stmt.body)
            for h in stmt.handlers:
                self._exec_block(h.body)
            self._exec_block(stmt.orelse)
            self._exec_block(stmt.finalbody)
        elif isinstance(stmt, ast.With):
            self._exec_block(stmt.body)
        # imports / pass / nested defs: no effect on the domain

    def _iter_iv(self, it):
        if isinstance(it, ast.Call):
            tail = it.func.id if isinstance(it.func, ast.Name) else None
            if tail in ("range", "reversed", "enumerate"):
                return HOST_TOP
        if isinstance(it, ast.Name) and it.id in self.o.tables \
                and it.id not in self.env:
            return self.o.tables[it.id]
        return self._as_iv(self.eval(it))

    def _join_env(self, a: Dict[str, object], b: Dict[str, object]):
        out: Dict[str, object] = {}
        for k in set(a) | set(b):
            if k in a and k in b:
                out[k] = self._join_any(a[k], b[k])
            else:
                out[k] = a.get(k, b.get(k))
        return out

    def _join_any(self, x, y):
        if isinstance(x, (list, tuple)) and isinstance(y, (list, tuple)) \
                and len(x) == len(y):
            return [self._join_any(a, b) for a, b in zip(x, y)]
        return self._as_iv(x).join(self._as_iv(y))

    def _fixpoint(self, body) -> None:
        """Iterate a loop body until the environment stabilizes. Findings
        are only reported on the final, post-fixpoint pass so transient
        pre-convergence intervals cannot fire spurious rules."""
        self._suppress_reports = True
        saved_checked = self.checked_ops
        for _ in range(_WIDEN_AFTER):
            before = dict(self.env)
            self._exec_block(body)
            self.env = self._join_env(before, self.env)
            if all(
                k in before and self._eq_any(before[k], self.env[k])
                for k in self.env
            ):
                break
        else:
            # No convergence: widen every loop-touched name to TOP.
            for k in list(self.env):
                if not self._as_iv(self.env[k]).host:
                    self.env[k] = self._top()
            self._exec_block(body)
        self._suppress_reports = False
        self.checked_ops = saved_checked
        self._exec_block(body)  # reporting pass at the fixed point

    @staticmethod
    def _eq_any(x, y) -> bool:
        if isinstance(x, (list, tuple)) and isinstance(y, (list, tuple)):
            return len(x) == len(y) and all(
                _FnAnalysis._eq_any(a, b) for a, b in zip(x, y)
            )
        return x == y

    # --- expressions -------------------------------------------------------

    def _as_iv(self, v) -> Iv:
        if isinstance(v, Iv):
            return v
        if isinstance(v, (list, tuple)):
            out: Optional[Iv] = None
            for e in v:
                iv = self._as_iv(e)
                out = iv if out is None else out.join(iv)
            return out if out is not None else Iv(0, 0)
        return self._top()

    def eval(self, node) -> object:
        if node is None:
            return Iv(0, 0)
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool):
                return BOOL
            if isinstance(node.value, int):
                return Iv(node.value, node.value, host=True)
            return Iv(0, 0, host=True)
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            if node.id in self.o.consts:
                c = self.o.consts[node.id]
                return Iv(c, c, host=True)
            if node.id in self.o.host_names:
                return HOST_TOP
            return self._top()
        if isinstance(node, ast.Tuple):
            return [self.eval(e) for e in node.elts]
        if isinstance(node, (ast.List, ast.Set)):
            return [self.eval(e) for e in node.elts]
        if isinstance(node, ast.Attribute):
            if node.attr in ("shape", "dtype", "ndim", "size", "strides",
                             "nbytes", "itemsize", "device"):
                return HOST_TOP
            if node.attr in ("T",):
                return self.eval(node.value)
            return self._as_iv(self.eval(node.value))
        if isinstance(node, ast.Subscript):
            base = self.eval(node.value)
            if isinstance(base, (list, tuple)):
                if isinstance(node.slice, ast.Constant) and isinstance(
                    node.slice.value, int
                ) and 0 <= node.slice.value < len(base):
                    return base[node.slice.value]
                return self._as_iv(base)
            return base
        if isinstance(node, ast.Compare):
            self.eval(node.left)
            for c in node.comparators:
                self.eval(c)
            return BOOL
        if isinstance(node, ast.BoolOp):
            for v in node.values:
                self.eval(v)
            return BOOL
        if isinstance(node, ast.UnaryOp):
            v = self._as_iv(self.eval(node.operand))
            if isinstance(node.op, ast.Invert):
                if v == BOOL or v.hi <= 1:
                    return BOOL
                return self._top()
            if isinstance(node.op, ast.Not):
                return BOOL
            if isinstance(node.op, ast.USub) and (v.host or self.signed):
                return Iv(-v.hi, -v.lo, v.host)
            return v
        if isinstance(node, ast.IfExp):
            self.eval(node.test)
            return self._join_any(self.eval(node.body), self.eval(node.orelse))
        if isinstance(node, ast.BinOp):
            a = self._as_iv(self.eval(node.left))
            b = self._as_iv(self.eval(node.right))
            return self._binop(node.op, a, b, node.lineno)
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            for g in node.generators:
                self._bind(g.target, self._iter_iv(g.iter))
                for cond in g.ifs:
                    self.eval(cond)
            return self._as_iv(self.eval(node.elt))
        if isinstance(node, ast.Starred):
            return self.eval(node.value)
        return self._top()

    # --- arithmetic with width checks --------------------------------------

    def _range_check(self, lo: int, hi: int, line: int, sym: str,
                     what: str, a: Iv, b: Iv) -> bool:
        """Flag a result [lo, hi] leaving the mode's range; True if it
        stayed inside."""
        self.checked_ops += 1
        if hi > self.max:
            self._flag("limb-overflow", line, sym,
                       f"{what} may exceed the {self.width}-bit "
                       f"{'signed carrier' if self.signed else 'limb width'}"
                       f" ([{a.lo},{a.hi}] {sym} [{b.lo},{b.hi}])")
            return False
        if lo < self.min:
            self._flag("limb-underflow", line, sym,
                       f"{what} may go below the {self.width}-bit "
                       f"{'signed carrier' if self.signed else 'limb range'}"
                       f" ([{a.lo},{a.hi}] {sym} [{b.lo},{b.hi}])")
            return False
        return True

    def _binop(self, op, a: Iv, b: Iv, line: int) -> Iv:
        if self.signed:
            return self._binop_signed(op, a, b, line)
        host = a.host and b.host
        if isinstance(op, ast.Add):
            if not host:
                self.checked_ops += 1
                if a.hi + b.hi > self.max:
                    self._flag(
                        "limb-overflow", line, "+",
                        f"add may exceed {self.width}-bit limb width "
                        f"([{a.lo},{a.hi}] + [{b.lo},{b.hi}])",
                    )
                    return self._top()
            return Iv(a.lo + b.lo, a.hi + b.hi, host)
        if isinstance(op, ast.Sub):
            if not host:
                self.checked_ops += 1
                if a.lo - b.hi < 0:
                    self._flag(
                        "limb-underflow", line, "-",
                        f"subtract may underflow "
                        f"([{a.lo},{a.hi}] - [{b.lo},{b.hi}])",
                    )
                    return self._top()
            return Iv(max(a.lo - b.hi, 0) if not host else a.lo - b.hi,
                      max(a.hi - b.lo, 0) if not host else a.hi - b.lo, host)
        if isinstance(op, ast.Mult):
            if not host:
                self.checked_ops += 1
                if a.hi * b.hi > self.max:
                    self._flag(
                        "limb-overflow", line, "*",
                        f"multiply may exceed {self.width}-bit limb width "
                        f"([{a.lo},{a.hi}] * [{b.lo},{b.hi}])",
                    )
                    return self._top()
            return Iv(a.lo * b.lo, a.hi * b.hi, host)
        if isinstance(op, ast.LShift):
            if not host:
                self.checked_ops += 1
                if b.hi > 1 << 16 or (a.hi << min(b.hi, 1 << 16)) > self.max:
                    self._flag(
                        "limb-overflow", line, "<<",
                        f"left shift may exceed {self.width}-bit limb width "
                        f"([{a.lo},{a.hi}] << [{b.lo},{b.hi}])",
                    )
                    return self._top()
            return Iv(a.lo << b.lo, a.hi << min(b.hi, 1 << 16), host)
        if isinstance(op, ast.RShift):
            return Iv(a.lo >> min(b.hi, 1 << 16), a.hi >> b.lo, host)
        if isinstance(op, ast.BitAnd):
            return Iv(0, min(a.hi, b.hi), host)
        if isinstance(op, (ast.BitOr, ast.BitXor)):
            return _bitlen_bound(a, b)
        if isinstance(op, ast.FloorDiv):
            return Iv(a.lo // max(b.hi, 1), a.hi // max(b.lo, 1), host)
        if isinstance(op, ast.Mod):
            return Iv(0, max(b.hi - 1, 0), host)
        if isinstance(op, ast.Pow) and host:
            return Iv(a.lo ** b.lo, a.hi ** b.hi, host=True)
        return self._top()

    def _binop_signed(self, op, a: Iv, b: Iv, line: int) -> Iv:
        """The int64-carrier transfer functions: exact corners, the
        carrier's range checked on + - * <<."""
        host = a.host and b.host
        if isinstance(op, (ast.Add, ast.Sub, ast.Mult, ast.LShift)):
            if isinstance(op, ast.Add):
                lo, hi, sym, what = a.lo + b.lo, a.hi + b.hi, "+", "add"
            elif isinstance(op, ast.Sub):
                lo, hi, sym, what = a.lo - b.hi, a.hi - b.lo, "-", "subtract"
            elif isinstance(op, ast.Mult):
                cs = (a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi)
                lo, hi, sym, what = min(cs), max(cs), "*", "multiply"
            else:
                if b.lo < 0 or b.hi > 1 << 16:
                    lo, hi = self.min - 1, self.max + 1
                else:
                    lo = min(a.lo << b.lo, a.lo << b.hi)
                    hi = max(a.hi << b.lo, a.hi << b.hi)
                sym, what = "<<", "left shift"
            if host:
                return Iv(lo, hi, True)
            if not self._range_check(lo, hi, line, sym, what, a, b):
                return self._top()
            return Iv(lo, hi)
        if isinstance(op, ast.RShift):
            s_lo, s_hi = max(b.lo, 0), min(max(b.hi, 0), 1 << 16)
            return Iv(min(a.lo >> s_lo, a.lo >> s_hi),
                      max(a.hi >> s_lo, a.hi >> s_hi), host)
        if isinstance(op, ast.BitAnd):
            nonneg = [x.hi for x in (a, b) if x.lo >= 0]
            if not nonneg:
                return self._top()
            if not host:
                self.checked_ops += 1  # proven: lands in [0, mask]
            return Iv(0, min(nonneg), host)
        if isinstance(op, (ast.BitOr, ast.BitXor)):
            if a.lo >= 0 and b.lo >= 0:
                return _bitlen_bound(a, b)
            return self._top()
        if isinstance(op, ast.FloorDiv) and b.lo > 0:
            return Iv(min(a.lo // b.lo, a.lo // b.hi),
                      max(a.hi // b.lo, a.hi // b.hi), host)
        if isinstance(op, ast.Mod) and b.lo > 0:
            return Iv(0, b.hi - 1, host)
        if isinstance(op, ast.Pow) and host:
            return Iv(a.lo ** b.lo, a.hi ** b.hi, host=True)
        return self._top()

    # --- calls -------------------------------------------------------------

    _CONST_CTORS = frozenset(("uint32", "uint64", "int32", "int64", "uint8",
                              "uint16", "int8", "int16"))
    _HULL_CALLS = frozenset(("where", "select", "stack", "concatenate",
                             "minimum", "maximum", "broadcast_to", "clip",
                             "sort", "unique", "reshape", "tile", "asarray",
                             # torch's spellings of the same hulls
                             "cat", "tensor", "as_tensor",
                             "broadcast_tensors", "expand", "repeat"))

    def _call(self, node: ast.Call) -> object:
        func = node.func
        tail = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else None
        )
        # Method chains: x.astype(...), x.reshape(...), .at[].add/set.
        if isinstance(func, ast.Attribute):
            if tail == "append" and isinstance(func.value, ast.Name):
                # Accumulator lists are modeled as a single hull element
                # (length-stable, so loop fixpoints converge).
                name = func.value.id
                iv = self._as_iv(self.eval(node.args[0])) if node.args \
                    else Iv(0, 0)
                cur = self.env.get(name)
                if isinstance(cur, list):
                    hull = iv if not cur else self._as_iv(cur).join(iv)
                    self.env[name] = [hull]
                return Iv(0, 0, host=True)
            if tail == "astype":
                base = self._as_iv(self.eval(func.value))
                if node.args and "bool" in ast.dump(node.args[0]):
                    return BOOL
                return base
            if tail == "to" and self.signed:
                base = self._as_iv(self.eval(func.value))
                if any("bool" in ast.dump(a) for a in node.args):
                    return BOOL
                return base
            if tail == "view" and self.signed:
                self.eval(func.value)
                return self._top()  # a bit reinterpretation
            if (self.signed and tail.endswith("_") and not tail.startswith("_")
                    and isinstance(func.value, ast.Name)):
                # An in-place method: the receiver's bound is unknown
                # unless the line's `range=` states it.
                for a in node.args:
                    self.eval(a)
                self.env[func.value.id] = self._top()
                return self._top()
            if tail in ("reshape", "copy", "flatten", "ravel"):
                return self.eval(func.value)
            if tail in ("add", "set", "subtract", "mul", "min", "max"):
                recv = func.value
                if isinstance(recv, ast.Subscript) and isinstance(
                    recv.value, ast.Attribute
                ) and recv.value.attr == "at":
                    base = self._as_iv(self.eval(recv.value.value))
                    argv = self._as_iv(
                        self.eval(node.args[0]) if node.args else Iv(0, 0)
                    )
                    if tail == "set":
                        return base.join(argv)
                    # Unbounded accumulation: TOP unless a line `range=`
                    # annotation (applied by the Assign handler) narrows
                    # the bound; the annotation carries the count proof.
                    return self._top()
        args = []
        for a in node.args:
            v = self.eval(a)
            if isinstance(a, ast.Starred) and isinstance(v, (list, tuple)):
                args.extend(v)  # f(*pair) binds pair's elements in order
            else:
                args.append(v)
        if tail in self._CONST_CTORS:
            # Machine-word constructor: the value leaves Python-int land
            # and wraps at the word width from here on.
            if not args:
                return Iv(0, 0)
            iv = self._as_iv(args[0])
            if iv.hi > self.max or iv.lo < self.min:
                iv = self._top()
            return Iv(iv.lo, iv.hi)
        if tail in ("zeros", "zeros_like", "empty"):
            return Iv(0, 0)
        if tail in ("ones", "ones_like"):
            if any("bool" in ast.dump(kw.value) for kw in node.keywords):
                return BOOL
            return Iv(1, 1)
        if tail == "full":
            return self._as_iv(args[1]) if len(args) > 1 else self._top()
        if tail in ("where", "select"):
            if len(args) >= 3:
                return self._join_any(args[1], args[2])
            return self._as_iv(args[-1]) if args else self._top()
        if tail in ("minimum", "min_"):
            if len(args) == 2:
                a, b = self._as_iv(args[0]), self._as_iv(args[1])
                return Iv(min(a.lo, b.lo), min(a.hi, b.hi), a.host and b.host)
        if tail == "maximum" and len(args) == 2:
            a, b = self._as_iv(args[0]), self._as_iv(args[1])
            return Iv(max(a.lo, b.lo), max(a.hi, b.hi), a.host and b.host)
        if tail == "clip" and len(args) >= 3:
            v, lo, hi = (self._as_iv(x) for x in args[:3])
            return Iv(max(v.lo, lo.lo), min(v.hi, hi.hi))
        if tail in self._HULL_CALLS:
            return self._as_iv(args) if args else self._top()
        if tail == "bit_length":
            return Iv(0, 256, host=True)
        if tail == "int":
            # Materializes to a Python int: arbitrary precision again.
            iv = self._as_iv(args) if args else HOST_TOP
            return Iv(iv.lo, iv.hi, host=True)
        if tail in ("len", "sum", "min", "max", "abs"):
            if tail == "len":
                return HOST_TOP
            return self._as_iv(args) if args else HOST_TOP
        if tail in ("range", "reversed", "enumerate", "arange"):
            return HOST_TOP
        if tail in ("broadcast_shapes",):
            return HOST_TOP
        # Local function: summary + declared-range obligations.
        if isinstance(func, ast.Name) and func.id in self.o.functions:
            return self._local_call(func.id, node, args)
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and tail in self.o.functions
        ):
            return self._local_call(tail, node, args)
        return self._top()

    def _local_call(self, name: str, node: ast.Call, args) -> object:
        summary = self.o.summary(name)
        fn = self.o.functions[name]
        params = [p.arg for p in fn.args.args]
        declared = self.o.declared_ranges.get(name, {})
        for pname, arg_iv in zip(params, args):
            d = declared.get(pname)
            if d is None:
                continue
            iv = self._as_iv(arg_iv)
            if iv.host:
                continue
            self.checked_ops += 1
            if iv.hi > d.hi or iv.lo < d.lo:
                self._flag(
                    "range-obligation", node.lineno, f"{name}.{pname}",
                    f"argument [{iv.lo},{iv.hi}] may exceed {name}()'s "
                    f"declared range {pname}:[{d.lo},{d.hi}]",
                )
        return summary if summary is not None else self._top()


class _FileAnalysis:
    def __init__(self, path: pathlib.Path, root: pathlib.Path,
                 width: int, signed: bool = False,
                 source: Optional[str] = None) -> None:
        self.width = width
        self.signed = signed
        source = path.read_text() if source is None else source
        try:
            self.rel = path.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            self.rel = path.as_posix()
        self.anns = ann_mod.collect(source)
        self.tree = ast.parse(source)
        self.functions: Dict[str, ast.FunctionDef] = {
            n.name: n for n in self.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        # Module constants, folded with Python (arbitrary-precision) ints.
        self.consts: Dict[str, int] = {}
        for n in self.tree.body:
            if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                    isinstance(n.targets[0], ast.Name):
                v = _const_fold(n.value)
                if v is not None:
                    self.consts[n.targets[0].id] = v
        # Module-level `NAME: int = ...` (Python ints of unknown value) and
        # constant tables (tuples of constant rows), iterated as host ints.
        self.host_names = {
            n.target.id for n in self.tree.body
            if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)
            and _is_int_hint(n.annotation)
        }
        self.tables: Dict[str, object] = {}
        for n in self.tree.body:
            if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                    isinstance(n.targets[0], ast.Name):
                row = _table_rows(n.value)
                if row is not None:
                    self.tables[n.targets[0].id] = row
        self.declared_ranges: Dict[str, Dict[str, Iv]] = {}
        self._summaries: Dict[str, object] = {}
        self._in_progress: set = set()
        self.findings: List[Finding] = []
        self.checked_ops = 0

    def summary(self, name: str):
        """Return-interval summary of a local function analyzed at its
        declared entry ranges (memoized; None on recursion)."""
        if name in self._summaries:
            return self._summaries[name]
        if name in self._in_progress:
            return None
        self._in_progress.add(name)
        fa = _FnAnalysis(self, self.functions[name], name)
        fa._suppress_reports = True  # findings come from the main pass
        fa.run()
        self._in_progress.discard(name)
        self._summaries[name] = fa.return_iv
        return fa.return_iv

    def run(self) -> Tuple[List[Finding], int]:
        # Pre-pass: register every function's declared ranges (call-site
        # obligations need them regardless of analysis order).
        for name, fn in self.functions.items():
            a = ann_mod.lookup(self.anns, fn.lineno)
            declared: Dict[str, Iv] = {}
            if a is not None and "range" in a:
                try:
                    declared = parse_ranges(a)
                except ValueError:
                    pass  # reported by the function's own analysis below
            self.declared_ranges[name] = declared
        for name, fn in self.functions.items():
            fa = _FnAnalysis(self, fn, name)
            fa.run()
            self.findings.extend(fa.findings)
            self.checked_ops += fa.checked_ops
        self.findings.sort(key=lambda f: (f.file, f.line, f.code))
        return self.findings, self.checked_ops


def _is_int_hint(node) -> bool:
    return isinstance(node, ast.Name) and node.id == "int"


def _table_rows(node):
    """A module-level tuple/list of constant rows (ints or strings, or
    tuples of them) as its iteration value: one host hull per column, or
    one hull for scalar rows. None if any element is not constant."""
    if not isinstance(node, (ast.Tuple, ast.List)) or not node.elts:
        return None

    def cell(e) -> Optional[Iv]:
        if isinstance(e, ast.Constant) and isinstance(e.value, str):
            return Iv(0, 0, host=True)
        v = _const_fold(e)
        return None if v is None else Iv(v, v, host=True)

    rows = []
    for e in node.elts:
        if isinstance(e, ast.Tuple):
            cells = [cell(x) for x in e.elts]
            if any(c is None for c in cells):
                return None
            rows.append(cells)
        else:
            c = cell(e)
            if c is None:
                return None
            rows.append([c])
    if len({len(r) for r in rows}) != 1:
        return None
    cols = [r[0] for r in rows]
    for r in rows:
        cols = [a.join(b) for a, b in zip(cols, r)]
    return cols if isinstance(node.elts[0], ast.Tuple) else cols[0]


def _const_fold(node) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.BinOp):
        a, b = _const_fold(node.left), _const_fold(node.right)
        if a is None or b is None:
            return None
        try:
            if isinstance(node.op, ast.Add):
                return a + b
            if isinstance(node.op, ast.Sub):
                return a - b
            if isinstance(node.op, ast.Mult):
                return a * b
            if isinstance(node.op, ast.LShift):
                return a << b
            if isinstance(node.op, ast.RShift):
                return a >> b
            if isinstance(node.op, ast.BitOr):
                return a | b
            if isinstance(node.op, ast.BitAnd):
                return a & b
            if isinstance(node.op, ast.BitXor):
                return a ^ b
        except (OverflowError, ValueError):
            return None
    if isinstance(node, ast.Call) and node.args:
        # np.uint64(CONST)-style constant wrappers.
        tail = node.func.attr if isinstance(node.func, ast.Attribute) else (
            node.func.id if isinstance(node.func, ast.Name) else None
        )
        if tail in ("uint8", "uint16", "uint32", "uint64",
                    "int8", "int16", "int32", "int64"):
            return _const_fold(node.args[0])
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _const_fold(node.operand)
        return -v if v is not None else None
    return None


def prove_file(path, root, mode: str,
               source: Optional[str] = None) -> Tuple[List[Finding], int]:
    """(findings, checked arithmetic-op count) for one Python file read in
    `mode` ("u32", "u64" or "i64"). `source` reads the file's text from
    the caller instead of the disk."""
    width, signed = MODES[mode]
    return _FileAnalysis(pathlib.Path(path), pathlib.Path(root), width,
                         signed, source).run()


# =========================================================================
# The CUDA front end
# =========================================================================

_VECTOR_TYPES = {  # CUDA's built-in vector structs
    "uint2": ("x", "y"), "uint4": ("x", "y", "z", "w"),
    "int2": ("x", "y"), "int4": ("x", "y", "z", "w"),
    "ulonglong2": ("x", "y"), "longlong2": ("x", "y"),
}
_INT32 = cparse.CType("int", 32, True)
_U64 = cparse.CType("int", 64, False)
# Device intrinsics that return their pointee's old value (opaque, full
# width) or a value of a known type.
_ATOMICS = frozenset(("atomicAdd", "atomicSub", "atomicExch", "atomicMax",
                      "atomicMin", "atomicOr", "atomicAnd", "atomicCAS"))


@dataclass(frozen=True)
class CI:
    """A C scalar: its interval and its type. `opaque` marks a value of
    unknown provenance (an unknown call), which converts without a
    finding."""

    iv: Iv
    t: cparse.CType
    opaque: bool = False


@dataclass(frozen=True)
class CS:
    """A struct value: its type name and its fields' values."""

    tname: str
    fields: Tuple[Tuple[str, object], ...]

    def get(self, f: str):
        return dict(self.fields).get(f)

    def with_field(self, f: str, v) -> "CS":
        d = dict(self.fields)
        d[f] = v
        return CS(self.tname, tuple(sorted(d.items())))


@dataclass(frozen=True)
class CP:
    """A pointer: the type its subscripts and dereferences read."""

    elem: cparse.CType


def _trange(t: cparse.CType) -> Iv:
    if t.boolean:
        return Iv(0, 1)
    if t.signed:
        return Iv(-(1 << (t.width - 1)), (1 << (t.width - 1)) - 1)
    return Iv(0, (1 << t.width) - 1)


def _tname(t: cparse.CType) -> str:
    if t.boolean:
        return "bool"
    return f"{'' if t.signed else 'u'}int{t.width}"


class _CudaFile:
    """The tables of one CUDA source: functions, typedefs, structs,
    constants, annotations; and the memoized callee summaries."""

    def __init__(self, src: str, rel: str) -> None:
        self.rel = rel
        self.toks, self.anns = cparse.lex(src)
        self.typedefs = cparse.typedef_types(src)
        self.structs = cparse.collect_structs(src)
        self.consts = dict(cparse.parse_constexprs(src))
        self.consts.update({k: v[0] for k, v in cparse.parse_defines(src).items()})
        self.type_names = frozenset(
            set(cparse.collect_typedefs(src)) | set(self.structs)
            | set(_VECTOR_TYPES))
        self.functions = {f.name: f for f in cparse.parse_functions(src)
                          if f.body is not None}
        self._bodies: Dict[str, cparse.SBlock] = {}
        self._summaries: Dict[str, "_CudaFn"] = {}
        self._in_progress: set = set()

    def body(self, name: str) -> cparse.SBlock:
        if name not in self._bodies:
            self._bodies[name] = cparse.parse_body(
                self.toks, self.functions[name].body, self.type_names)
        return self._bodies[name]

    def resolve(self, t: cparse.CType) -> cparse.CType:
        """Typedef names resolved to their type (pointer depth kept)."""
        if t.base.startswith("named:"):
            alias = self.typedefs.get(t.base[6:])
            if alias is not None:
                return cparse.CType(alias.base, alias.width, alias.signed,
                                    alias.ptr + t.ptr, alias.boolean)
        return t

    def fields_of(self, tname: str):
        if tname in _VECTOR_TYPES:
            w, signed = (64, tname.startswith("long")) if "longlong" in tname \
                else (32, not tname.startswith("u"))
            return [(f, cparse.CType("int", w, signed))
                    for f in _VECTOR_TYPES[tname]]
        return self.structs.get(tname)

    def top_of(self, t: cparse.CType):
        """The value a declaration of type `t` holds before anything is
        known: the type's full range, a struct of such fields, or a
        pointer."""
        t = self.resolve(t)
        if t.ptr > 0:
            return CP(cparse.CType(t.base, t.width, t.signed, t.ptr - 1,
                                   t.boolean))
        if t.base == "int":
            return CI(_trange(t), t)
        if t.base.startswith("named:"):
            fields = self.fields_of(t.base[6:])
            if fields is not None:
                return CS(t.base[6:], tuple(sorted(
                    (f, self.top_of(ft)) for f, ft in fields)))
        return CI(_trange(_U64), _U64, opaque=True)

    def summary(self, name: str) -> Optional["_CudaFn"]:
        """The callee analysed at its declared entry ranges (memoized;
        None on recursion)."""
        if name in self._summaries:
            return self._summaries[name]
        if name in self._in_progress:
            return None
        self._in_progress.add(name)
        fa = _CudaFn(self, self.functions[name])
        fa.suppress = True  # findings come from the function's own run
        fa.run()
        self._in_progress.discard(name)
        self._summaries[name] = fa
        return fa


class _CudaFn:
    """Width-aware interval interpretation of one device function."""

    def __init__(self, cf: _CudaFile, fn: cparse.CFunc) -> None:
        self.cf = cf
        self.fn = fn
        self.findings: List[Finding] = []
        self.checked_ops = 0
        self.suppress = False
        self.ret = None
        self.out_params: Dict[str, object] = {}
        self.declared: Dict[str, Iv] = {}
        self._ret_envs: List[dict] = []

    # --- reporting ---

    def _flag(self, code: str, line: int, subject: str, msg: str) -> None:
        if self.suppress:
            return
        for ln in (line, self.fn.line):
            a = ann_mod.lookup(self.cf.anns, ln)
            if a is not None and (a.allows(code) or a.allows("absint")):
                return
        f = Finding("absint", code, self.cf.rel, line, self.fn.name,
                    subject, msg)
        if f not in self.findings:
            self.findings.append(f)

    def _line_ranges(self, line: int) -> Dict[str, Iv]:
        a = ann_mod.lookup(self.cf.anns, line)
        if a is None or "range" not in a.clauses:
            return {}
        try:
            return parse_ranges(a)
        except ValueError as e:
            self._flag("bad-range", line, "range", str(e))
            return {}

    # --- entry ---

    def run(self) -> None:
        self.declared = self._line_ranges(self.fn.line)
        env: Dict[str, object] = {}
        for p in self.fn.params:
            if not p.name:
                continue
            v = self.cf.top_of(p.ctype)
            d = self.declared.get(p.name)
            if d is not None and isinstance(v, CI):
                v = CI(Iv(d.lo, d.hi), v.t)
            env[p.name] = v
        final = self._exec(self.cf.body(self.fn.name), env)
        for r in self._ret_envs:  # every path out of the function
            final = self._join(final, r)
        for p in self.fn.params:
            if p.ref and final is not None and p.name in final:
                self.out_params[p.name] = final[p.name]

    # --- values ---

    @staticmethod
    def _join_val(a, b):
        if a is None:
            return b
        if b is None:
            return a
        if isinstance(a, CI) and isinstance(b, CI):
            return CI(a.iv.join(b.iv), a.t, a.opaque or b.opaque)
        if isinstance(a, CS) and isinstance(b, CS) and a.tname == b.tname:
            da, db = dict(a.fields), dict(b.fields)
            return CS(a.tname, tuple(sorted(
                (k, _CudaFn._join_val(da.get(k), db.get(k))) for k in da)))
        return a if a == b else b

    @classmethod
    def _join(cls, a: Optional[dict], b: Optional[dict]) -> Optional[dict]:
        if a is None:
            return None if b is None else dict(b)
        if b is None:
            return dict(a)
        return {k: cls._join_val(a[k], b[k]) for k in a.keys() & b.keys()}

    def _convert(self, v, t: cparse.CType, line: int, explicit: bool):
        """`v` converted to type `t` (an initialisation, an assignment, an
        argument or a cast). An implicit conversion that may truncate is
        a `limb-overflow`; an explicit cast wraps as the source says."""
        t = self.cf.resolve(t)
        if t.ptr > 0:
            return v if isinstance(v, CP) else self.cf.top_of(t)
        if t.base != "int":
            return v if isinstance(v, CS) else self.cf.top_of(t)
        if not isinstance(v, CI):
            return CI(_trange(t), t)
        if t.boolean:
            lo = 0 if v.iv.lo <= 0 <= v.iv.hi else 1
            hi = 0 if v.iv.lo == v.iv.hi == 0 else 1
            return CI(Iv(lo, hi), t)
        r = _trange(t)
        if r.lo <= v.iv.lo and v.iv.hi <= r.hi:
            if not explicit and (v.t.width or 0) > t.width:
                self.checked_ops += 1  # a narrowing proven exact
            return CI(Iv(v.iv.lo, v.iv.hi), t)
        if not explicit and not v.opaque:
            self.checked_ops += 1
            self._flag("limb-overflow", line, _tname(t),
                       f"implicit conversion to {_tname(t)} may truncate "
                       f"[{v.iv.lo},{v.iv.hi}]")
        return CI(r, t)

    @staticmethod
    def _promote(t: cparse.CType) -> cparse.CType:
        if t.boolean or t.width < 32:
            return _INT32
        return t

    def _common(self, a: cparse.CType, b: cparse.CType) -> cparse.CType:
        a, b = self._promote(a), self._promote(b)
        if a.width == b.width:
            return a if not a.signed else b
        return a if a.width > b.width else b

    def _literal(self, n: cparse.Num) -> CI:
        """A literal's type: the first of int / unsigned int / long long /
        unsigned long long (`u` drops the signed ones, `l` the 32-bit ones)
        that holds its value."""
        signs = (False,) if "u" in n.suffix else (True, False)
        for w in ((64,) if "l" in n.suffix else (32, 64)):
            for signed in signs:
                t = cparse.CType("int", w, signed)
                r = _trange(t)
                if r.lo <= n.v <= r.hi:
                    return CI(Iv(n.v, n.v), t)
        return CI(Iv(n.v, n.v), cparse.CType("int", 128, False))

    # --- expressions ---

    def _arith(self, op: str, a: CI, b: CI, line: int) -> CI:
        if op in ("<<", ">>"):
            t = self._promote(a.t)
        else:
            t = self._common(a.t, b.t)
        r = _trange(t)
        x, y = a.iv, b.iv
        if op in ("+", "-", "*", "<<"):
            if op == "+":
                lo, hi, what = x.lo + y.lo, x.hi + y.hi, "add"
            elif op == "-":
                lo, hi, what = x.lo - y.hi, x.hi - y.lo, "subtract"
            elif op == "*":
                cs = (x.lo * y.lo, x.lo * y.hi, x.hi * y.lo, x.hi * y.hi)
                lo, hi, what = min(cs), max(cs), "multiply"
            else:
                if y.lo < 0 or y.hi >= t.width or x.lo < 0:
                    lo, hi = r.lo - 1, r.hi + 1
                else:
                    lo, hi = x.lo << y.lo, x.hi << y.hi
                what = "left shift"
            if a.opaque or b.opaque:
                return CI(r, t, opaque=True)
            self.checked_ops += 1
            msg = (f"[{x.lo},{x.hi}] {op} [{y.lo},{y.hi}] as {_tname(t)}")
            if hi > r.hi:
                self._flag("limb-overflow", line, op,
                           f"{what} may exceed {_tname(t)}: {msg}")
                return CI(r, t)
            if lo < r.lo:
                self._flag("limb-underflow", line, op,
                           f"{what} may go below {_tname(t)}'s range: {msg}")
                return CI(r, t)
            return CI(Iv(lo, hi), t)
        if x.lo < 0 or y.lo < 0:
            return CI(r, t, a.opaque or b.opaque)
        if op == ">>":
            return CI(Iv(x.lo >> min(y.hi, 1 << 16), x.hi >> y.lo), t)
        if op == "&":
            return CI(Iv(0, min(x.hi, y.hi)), t)
        if op in ("|", "^"):
            return CI(_bitlen_bound(x, y), t)
        if op == "/" and y.lo > 0:
            return CI(Iv(x.lo // y.hi, x.hi // y.lo), t)
        if op == "%" and y.lo > 0:
            return CI(Iv(0, y.hi - 1), t)
        return CI(r, t)

    _CMP = frozenset(("==", "!=", "<", ">", "<=", ">=", "&&", "||"))

    def _eval(self, e, env: dict):
        if isinstance(e, cparse.Num):
            return self._literal(e)
        if isinstance(e, cparse.Name):
            if e.n in env:
                return env[e.n]
            if e.n in ("true", "false"):
                b = int(e.n == "true")
                return CI(Iv(b, b), cparse.CType("int", 8, False, boolean=True))
            if e.n in self.cf.consts:
                v = self.cf.consts[e.n]
                return CI(Iv(v, v), _U64 if v > 0x7FFFFFFF else _INT32)
            return CI(_trange(_U64), _U64, opaque=True)
        if isinstance(e, cparse.Bin):
            if e.op in ("&&", "||"):
                self._eval(e.l, dict(env))
                self._eval(e.r, dict(env))
                return CI(BOOL, cparse.CType("int", 8, False, boolean=True))
            lv, rv = self._eval(e.l, env), self._eval(e.r, env)
            if e.op in self._CMP:
                return CI(BOOL, cparse.CType("int", 8, False, boolean=True))
            if isinstance(lv, CP) and isinstance(rv, CI):
                return lv  # pointer arithmetic keeps the element type
            if isinstance(lv, CI) and isinstance(rv, CI):
                return self._arith(e.op, lv, rv, e.line)
            return CI(_trange(_U64), _U64, opaque=True)
        if isinstance(e, cparse.Un):
            v = self._eval(e.e, env)
            if e.op == "!":
                return CI(BOOL, cparse.CType("int", 8, False, boolean=True))
            if e.op == "*":
                return self.cf.top_of(v.elem) if isinstance(v, CP) else v
            if e.op == "&":
                return CP(v.t if isinstance(v, CI) else _U64)
            if not isinstance(v, CI):
                return v
            t = self._promote(v.t)
            r = _trange(t)
            if e.op == "~":
                if v.iv.lo < 0 and not t.signed:
                    return CI(r, t)
                if t.signed:
                    return CI(Iv(-v.iv.hi - 1, -v.iv.lo - 1), t)
                return CI(Iv(r.hi - v.iv.hi, r.hi - v.iv.lo), t)
            if e.op == "-":
                return self._arith("-", CI(Iv(0, 0), t), v, e.line)
            return CI(v.iv, t)
        if isinstance(e, cparse.IncDec):
            if isinstance(e.e, cparse.Name) and isinstance(env.get(e.e.n), CI):
                old = env[e.e.n]
                new = self._arith("+" if e.op == "++" else "-", old,
                                  CI(Iv(1, 1), _INT32), e.line)
                env[e.e.n] = self._convert(new, old.t, e.line, explicit=True)
                return old if e.post else env[e.e.n]
            return self._eval(e.e, env)
        if isinstance(e, cparse.Call):
            return self._call(e, env)
        if isinstance(e, cparse.Idx):
            bv = self._eval(e.base, env)
            self._eval(e.idx, env)
            if isinstance(bv, CP):
                return self.cf.top_of(bv.elem)
            return CI(_trange(_U64), _U64, opaque=True)
        if isinstance(e, cparse.Mem):
            bv = self._eval(e.base, env)
            if isinstance(bv, CS):
                v = bv.get(e.f)
                if v is not None:
                    return v
            return CI(_trange(_U64), _U64, opaque=True)
        if isinstance(e, cparse.Cast):
            v = self._eval(e.e, env)
            if e.ctype is None:
                return v
            return self._convert(v, e.ctype, e.line, explicit=True)
        if isinstance(e, cparse.Cond):
            self._eval(e.c, dict(env))
            a = self._eval(e.a, self._cond(dict(env), e.c, True) or dict(env))
            b = self._eval(e.b, self._cond(dict(env), e.c, False) or dict(env))
            if isinstance(a, CI) and isinstance(b, CI):
                t = self._common(a.t, b.t)
                return CI(a.iv.join(b.iv), t, a.opaque or b.opaque)
            return self._join_val(a, b)
        if isinstance(e, cparse.Assign):
            return self._assign(e, env)
        return CI(_trange(_U64), _U64, opaque=True)

    def _call(self, e: cparse.Call, env: dict):
        name = e.fn.n if isinstance(e.fn, cparse.Name) else None
        args = [self._eval(a, env) for a in e.args]
        if name in _ATOMICS and args and isinstance(args[0], CP):
            return self.cf.top_of(args[0].elem)
        if name and name.startswith("make_") and name[5:] in _VECTOR_TYPES:
            fields = self.cf.fields_of(name[5:])
            return CS(name[5:], tuple(sorted(
                (f, self._convert(a, ft, e.line, explicit=False))
                for (f, ft), a in zip(fields, args))))
        if name in ("min", "max") and len(args) == 2 and all(
                isinstance(a, CI) for a in args):
            a, b = args
            pick = min if name == "min" else max
            return CI(Iv(pick(a.iv.lo, b.iv.lo), pick(a.iv.hi, b.iv.hi)),
                      self._common(a.t, b.t))
        if name not in self.cf.functions:
            return CI(_trange(_U64), _U64, opaque=True)
        callee = self.cf.functions[name]
        summ = self.cf.summary(name)
        for p, a in zip(callee.params, args):
            d = summ.declared.get(p.name) if summ is not None else None
            if d is not None and isinstance(a, CI) and not a.opaque:
                self.checked_ops += 1
                if a.iv.lo < d.lo or a.iv.hi > d.hi:
                    self._flag(
                        "range-obligation", e.line, f"{name}.{p.name}",
                        f"argument [{a.iv.lo},{a.iv.hi}] may exceed "
                        f"{name}()'s declared range {p.name}:[{d.lo},{d.hi}]")
            elif p.ref or p.ctype.ptr:
                continue
            else:
                self._convert(a, p.ctype, e.line, explicit=False)
        if summ is None:
            return self.cf.top_of(callee.ret)
        # Reference parameters come back with the callee's final values.
        for p, arg in zip(callee.params, e.args):
            if p.ref and p.name in summ.out_params:
                self._store(arg, summ.out_params[p.name], env, e.line)
        if summ.ret is None:
            return self.cf.top_of(callee.ret)
        return self._convert(summ.ret, callee.ret, e.line, explicit=False)

    def _store(self, target, val, env: dict, line: int) -> None:
        """Assign `val` to an lvalue: a name, or a member of a named
        struct value (`w.hi`); stores through pointers change nothing
        the domain tracks."""
        if isinstance(target, cparse.Name):
            cur = env.get(target.n)
            if isinstance(cur, CI):
                val = self._convert(val, cur.t, line, explicit=False)
            env[target.n] = val
            for name, iv in self._line_ranges(line).items():
                if isinstance(env.get(name), CI):
                    env[name] = CI(iv, env[name].t)
        elif isinstance(target, cparse.Mem) and isinstance(
                target.base, cparse.Name):
            base = env.get(target.base.n)
            if isinstance(base, CS):
                cur = base.get(target.f)
                if isinstance(cur, CI):
                    val = self._convert(val, cur.t, line, explicit=False)
                env[target.base.n] = base.with_field(target.f, val)
        else:
            self._eval(target, env)

    def _assign(self, e: cparse.Assign, env: dict):
        val = self._eval(e.value, env)
        if e.op != "=":
            cur = self._eval(e.target, dict(env))
            if isinstance(cur, CI) and isinstance(val, CI):
                val = self._arith(e.op[:-1], cur, val, e.line)
            elif isinstance(cur, CP):
                val = cur
        self._store(e.target, val, env, e.line)
        return val

    # --- conditions ---

    def _cond(self, env: Optional[dict], c, truth: bool) -> Optional[dict]:
        if env is None:
            return None
        if isinstance(c, cparse.Un) and c.op == "!":
            return self._cond(env, c.e, not truth)
        if isinstance(c, cparse.Bin) and c.op == "&&":
            if truth:
                return self._cond(self._cond(env, c.l, True), c.r, True)
            return env
        if isinstance(c, cparse.Bin) and c.op == "||":
            if not truth:
                return self._cond(self._cond(env, c.l, False), c.r, False)
            return env
        if isinstance(c, cparse.Name) and isinstance(env.get(c.n), CI):
            return self._narrow(env, c.n, "!=" if truth else "==", Iv(0, 0))
        if isinstance(c, cparse.Bin) and c.op in (
                "<", "<=", ">", ">=", "==", "!="):
            op = c.op if truth else {
                "<": ">=", "<=": ">", ">": "<=", ">=": "<",
                "==": "!=", "!=": "=="}[c.op]
            for side, other, o in ((c.l, c.r, op), (c.r, c.l, {
                    "<": ">", ">": "<", "<=": ">=", ">=": "<=",
                    "==": "==", "!=": "!="}[op])):
                if isinstance(side, cparse.Name) and isinstance(
                        env.get(side.n), CI):
                    ov = self._eval(other, dict(env))
                    if isinstance(ov, CI) and not ov.opaque:
                        env = self._narrow(env, side.n, o, ov.iv)
                        if env is None:
                            return None
            return env
        return env

    @staticmethod
    def _narrow(env: dict, name: str, op: str, r: Iv) -> Optional[dict]:
        cur: CI = env[name]
        lo, hi = cur.iv.lo, cur.iv.hi
        if op == "<":
            hi = min(hi, r.hi - 1)
        elif op == "<=":
            hi = min(hi, r.hi)
        elif op == ">":
            lo = max(lo, r.lo + 1)
        elif op == ">=":
            lo = max(lo, r.lo)
        elif op == "==":
            lo, hi = max(lo, r.lo), min(hi, r.hi)
        elif op == "!=" and r.lo == r.hi:
            if r.lo == lo:
                lo += 1
            if r.lo == hi:
                hi -= 1
        if lo > hi:
            return None
        env = dict(env)
        env[name] = CI(Iv(lo, hi), cur.t, cur.opaque)
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
                    env[name] = self.cf.top_of(
                        cparse.CType(ct.base, ct.width, ct.signed, ct.ptr + 1,
                                     ct.boolean))
                    continue
                v = self.cf.top_of(ct)
                if init is not None and not isinstance(init, cparse.InitList):
                    v = self._convert(self._eval(init, env), ct, line,
                                      explicit=False)
                env[name] = v
                for n, iv in self._line_ranges(line).items():
                    if isinstance(env.get(n), CI):
                        env[n] = CI(iv, env[n].t)
            return env
        if isinstance(s, cparse.SExpr):
            self._eval(s.e, env)
            return env
        if isinstance(s, cparse.SRet):
            if s.e is not None:
                v = self._eval(s.e, env)
                self.ret = self._join_val(self.ret, v)
            self._ret_envs.append(dict(env))
            return None
        if isinstance(s, cparse.SIf):
            t_env = self._cond(dict(env), s.c, True)
            e_env = self._cond(dict(env), s.c, False)
            self._eval(s.c, dict(env))
            t_out = self._exec(s.t, t_env)
            e_out = self._exec(s.e, e_env) if s.e is not None else e_env
            return self._join(t_out, e_out)
        if isinstance(s, (cparse.SWhile, cparse.SFor)):
            # No listed helper loops; a loop's carried bounds need a
            # fixed point this front end does not have yet (fail closed).
            raise cparse.CParseError("a loop: outside the proven subset", s.line)
        return env


def prove_cuda_function(path, rel: str, fname: str,
                        source: Optional[str] = None
                        ) -> Tuple[List[Finding], int]:
    """(findings, checked-operation count) for one device function of a
    CUDA source. A function that is missing or outside the subset is a
    `c-parse` finding: the proof must not silently skip it."""
    try:
        src = pathlib.Path(path).read_text() if source is None else source
    except OSError as e:
        return ([Finding("absint", "c-parse", rel, 0, fname, fname,
                         f"cannot read source: {e}")], 0)
    cf = _CudaFile(src, rel)
    fn = cf.functions.get(fname)
    if fn is None:
        return ([Finding(
            "absint", "c-parse", rel, 0, fname, fname,
            f"listed function {fname} not found in {rel}: the proof must "
            "not silently skip it")], 0)
    try:
        cf.body(fname)
    except cparse.CParseError as e:
        return ([Finding("absint", "c-parse", rel, e.line, fname, fname,
                         f"body outside the analysable subset: {e}")], 0)
    fa = _CudaFn(cf, fn)
    try:
        fa.run()
    except (cparse.CParseError, RecursionError) as e:
        return ([Finding("absint", "c-parse", rel, getattr(e, "line", fn.line),
                         fname, fname, f"analysis failed: {e}")], 0)
    return sorted(fa.findings, key=lambda f: (f.line, f.code)), fa.checked_ops


def run_counts(root) -> Dict[str, Tuple[List[Finding], int]]:
    """Every target's (findings, checked count): the Python files of
    manifest.ABSINT_TARGETS and the device functions of
    manifest.ABSINT_CUDA_FUNCS (keyed `file::function`)."""
    root = pathlib.Path(root)
    out: Dict[str, Tuple[List[Finding], int]] = {}
    for rel, mode in manifest.ABSINT_TARGETS.items():
        path = root / rel
        if path.exists():
            out[rel] = prove_file(path, root, mode)
        else:
            out[rel] = ([Finding("absint", "c-parse", rel, 0, "module", rel,
                                 "listed target missing")], 0)
    for rel, fname in manifest.ABSINT_CUDA_FUNCS:
        out[f"{rel}::{fname}"] = prove_cuda_function(root / rel, rel, fname)
    return out


def run(root) -> List[Finding]:
    findings: List[Finding] = []
    for fs, _n in run_counts(root).values():
        findings.extend(fs)
    findings.sort(key=lambda f: (f.file, f.line, f.code))
    return findings
