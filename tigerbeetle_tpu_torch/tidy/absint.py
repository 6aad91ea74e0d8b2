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

The CUDA front end (`prove_cuda_function`) reads the device code where
the port's carries now live (manifest.ABSINT_CUDA_FUNCS: the shared
helpers and the commit kernels whole) through tidy/cparse.py, the C front
end of `native-absint`, with the quoted includes beside each file. Each
value carries its C type: widths and signedness come from the
declarations (`uint32_t`, `unsigned long long`, `u128` = `unsigned
__int128`, `uint2` / `uint4` members, struct fields, `constexpr`
constants), the usual arithmetic conversions pick each operation's type,
and an operation whose exact result may leave that type's range is a
finding with the same codes. An implicit conversion that may truncate (an
assignment, an argument or a return into a narrower type) is a
`limb-overflow` too; an explicit cast is the source saying so. So is an
address offset whose bytes may leave the 64-bit range, and a division by
a divisor that may be 0.

  - Loops: a loop whose condition the intervals decide at every pass (a
    `#pragma unroll` over a template constant, `for (int o = 16; o; o >>=
    1)`) is read one iteration at a time; any other loop runs to a fixed
    point with widening, then narrows by its condition. A loop the front
    end cannot read is a `c-parse` finding, never a silent pass.
  - Templates are read at each instantiation (`name<args>` in the
    manifest; at a call, explicit or deduced from the arguments' types);
    `[&]` lambdas inline at each call, in the caller's frame; aggregate
    initialisers member by member; an inline asm output at the full range
    of its register; a local array as the hull of its elements, and a
    short one of constant length element by element.
  - Intrinsics: a shuffle returns the interval of the value it moves; a
    vote, a bit count or a barrier-reduction its result range; a
    cache-hinted load and an atomic their pointee at full width.
  - Guards: a branch narrows each local variable path (`blockIdx.x`,
    `p.m`, `rows[k]` at a known k) its condition bounds, through casts
    that keep the value and through `(x >> k) == 0`; `__all_sync(m, p)`
    true (and `__any_sync(m, p)` false) narrow by p; a comparison `x >= y`
    is remembered, so that `x - y` under it is not below 0 (also through
    a bool defined as `x < y`), until a store to a name either reads; a
    product at least 1 of non-negative factors bounds each factor, and a
    quotient times its divisor stays below the dividend.
  - Calls to functions of the translation unit are summarised at the
    callee's declared ranges (its return value and its non-const
    reference parameters' final values), and the callee's `range=` (on a
    parameter or a path through it, `g.a`, `a.shard.base`) is a call
    obligation. A kernel's own `range=` may bound the launch too
    (`gridDim.x`, `blockIdx.x`); its threads are bounded by
    `__launch_bounds__`. A value of unknown provenance (an unknown call)
    that reaches arithmetic is a `c-parse` finding.

Annotations are `/* tidy: range=... */` and `// tidy: allow=...`, the
grammar `native-absint` reads; a comment-only annotation binds to the line
after its end, and a function's contract may sit anywhere in its head
from its `template` line on. A `range=` on a line bounds the named value
where the line starts and after its store (a loop-carried count that a
relation bounds).

`prove_file` and `prove_cuda_function` return the checked-operation count
so the tests can see that the interpreter visited the arithmetic instead
of skipping it.
"""

from __future__ import annotations

import ast
import functools
import pathlib
import posixpath
import re
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
    "uint3": ("x", "y", "z"), "dim3": ("x", "y", "z"),
}
_INT32 = cparse.CType("int", 32, True)
_U32 = cparse.CType("int", 32, False)
_U64 = cparse.CType("int", 64, False)
_BOOL_T = cparse.CType("int", 8, False, boolean=True)
# Device intrinsics: atomics return their pointee's old value (full width);
# a shuffle returns the interval of the value it moves; a vote, a bit
# count or a barrier-reduction returns its result range; a cache-hinted
# load returns its pointee at full width.
_ATOMICS = frozenset(("atomicAdd", "atomicSub", "atomicExch", "atomicMax",
                      "atomicMin", "atomicOr", "atomicAnd", "atomicCAS"))
_SHUFFLES = frozenset(("__shfl_sync", "__shfl_up_sync", "__shfl_down_sync",
                       "__shfl_xor_sync"))
_VOTES = frozenset(("__any_sync", "__all_sync", "__syncthreads_or",
                    "__syncthreads_and"))
_RESULT_RANGES = {"__ffs": 32, "__ffsll": 64, "__popc": 32, "__popcll": 64,
                  "__clz": 32, "__clzll": 64, "__syncthreads_count": 1024}
_REDUCE_BITS = frozenset(("__reduce_or_sync", "__reduce_and_sync",
                          "__reduce_xor_sync"))
_LOADS = frozenset(("__ldcg", "__ldcs", "__ldg", "__ldca", "__ldlu", "__ldcv"))
_VOID_CALLS = frozenset(("__syncthreads", "__syncwarp", "__threadfence",
                         "__threadfence_block", "__threadfence_system",
                         "__stcs", "__stcg", "__stwt", "__stcwb", "__nanosleep"))
_ASM_BITS = {"r": 32, "l": 64, "h": 16, "c": 8}  # an asm output's register width
_MAX_THREADS = 1024  # threads a block, without __launch_bounds__
_C_WIDEN_AFTER = 3  # fixed-point passes over a loop before widening
_CONVERGE_MAX = 64   # ... and before giving up (a c-parse finding)
_UNROLL_MAX = 256    # iterations of a constant-trip loop read one by one
_NEG = {"<": ">=", "<=": ">", ">": "<=", ">=": "<", "==": "!=", "!=": "=="}
_SWAP = {"<": ">", ">": "<", "<=": ">=", ">=": "<=", "==": "==", "!=": "!="}


@dataclass(frozen=True)
class CI:
    """A C scalar: its interval and its type. `opaque` marks a value of
    unknown provenance (an unknown call); arithmetic on one is a
    `c-parse` finding, never a silent pass."""

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


@dataclass(frozen=True)
class CA:
    """A local array: the hull of its elements and, for a short array of
    a constant length, each element (a store at a known index replaces
    that element; at an unknown one it joins into every element)."""

    elem: object
    items: Optional[tuple] = None


def _ca(items) -> CA:
    hull = None
    for v in items:
        hull = v if hull is None else _join_vals(hull, v)
    return CA(hull, tuple(items))


def _join_vals(a, b):
    """The hull of two values of one type (None: nothing known)."""
    if a is None:
        return b
    if b is None:
        return a
    if isinstance(a, CI) and isinstance(b, CI):
        return CI(a.iv.join(b.iv), a.t, a.opaque or b.opaque)
    if isinstance(a, CS) and isinstance(b, CS) and a.tname == b.tname:
        da, db = dict(a.fields), dict(b.fields)
        return CS(a.tname, tuple(sorted(
            (k, _join_vals(da.get(k), db.get(k))) for k in da)))
    if isinstance(a, CA) and isinstance(b, CA):
        if a.items is not None and b.items is not None and \
                len(a.items) == len(b.items):
            return _ca([_join_vals(x, y) for x, y in zip(a.items, b.items)])
        return CA(_join_vals(a.elem, b.elem))
    return a if a == b else b


_ITEMS_MAX = 64  # elements a local array tracks one by one


@dataclass(frozen=True, eq=False)
class CL:
    """A lambda, read inline at each call in its caller's frame (every
    capture is by reference)."""

    lam: object


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


def _cmp(op: str, x: Iv, y: Iv) -> Iv:
    """A comparison's value: [1, 1] or [0, 0] where the intervals decide
    it, else [0, 1]."""
    if op == "<":
        t, f = x.hi < y.lo, x.lo >= y.hi
    elif op == "<=":
        t, f = x.hi <= y.lo, x.lo > y.hi
    elif op == ">":
        t, f = x.lo > y.hi, x.hi <= y.lo
    elif op == ">=":
        t, f = x.lo >= y.hi, x.hi < y.lo
    else:
        same = x.lo == x.hi == y.lo == y.hi
        apart = x.hi < y.lo or y.hi < x.lo
        t, f = (same, apart) if op == "==" else (apart, same)
    return Iv(1, 1) if t else Iv(0, 0) if f else BOOL


def _path_of(e, index=None) -> Optional[Tuple[str, ...]]:
    """A local variable path (`x`, `s.carry`, `blockIdx.x`, and, where
    `index` gives a subscript's constant value, `rows[1]` as `rows.#1`)
    or None."""
    if isinstance(e, cparse.Name):
        return (e.n,)
    if isinstance(e, cparse.Mem):
        base = _path_of(e.base, index)
        return None if base is None else base + (e.f,)
    if isinstance(e, cparse.Idx) and index is not None:
        i = index(e.idx)
        base = _path_of(e.base, index)
        return None if base is None or i is None else base + (f"#{i}",)
    return None


def _path_get(v, segs):
    for s in segs:
        if s.startswith("#"):
            if not (isinstance(v, CA) and v.items is not None
                    and int(s[1:]) < len(v.items)):
                return None
            v = v.items[int(s[1:])]
            continue
        while isinstance(v, CA):
            v = v.elem
        if not isinstance(v, CS):
            return None
        v = v.get(s)
    return v


def _path_set(v, segs, fn):
    """`v` with the value at `segs` (through struct fields and array
    elements: every element, or the one a `#i` segment names) replaced
    by fn(old)."""
    if not segs:
        return fn(v)
    if isinstance(v, CA):
        if segs[0].startswith("#"):
            k = int(segs[0][1:])
            if v.items is None or k >= len(v.items):
                return v
            items = list(v.items)
            items[k] = _path_set(items[k], segs[1:], fn)
            return _ca(items)
        if v.items is not None:
            return _ca([_path_set(x, segs, fn) for x in v.items])
        return CA(_path_set(v.elem, segs, fn))
    if isinstance(v, CS) and v.get(segs[0]) is not None:
        return v.with_field(segs[0], _path_set(v.get(segs[0]), segs[1:], fn))
    return v


_INCLUDE_RE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


class _CudaFile:
    """The tables of one CUDA translation unit (the file and the quoted
    includes beside it): functions, typedefs, structs, constants,
    annotations by unit; and the memoized callee summaries."""

    def __init__(self, src: str, rel: str,
                 path: Optional[pathlib.Path] = None) -> None:
        self.rel = rel
        self.units: Dict[str, tuple] = {}  # rel -> (toks, anns)
        self.functions: Dict[str, Tuple[cparse.CFunc, str]] = {}
        self.typedefs: Dict[str, cparse.CType] = {}
        self.structs: Dict[str, list] = {}
        self.consts: Dict[str, tuple] = {}  # name -> (value, CType or None)
        names: set = set()
        self._load(src, rel, path, set(), names)
        self.type_names = frozenset(names | set(self.structs) | set(_VECTOR_TYPES))
        self.templates = frozenset(
            n for n, (f, _u) in self.functions.items() if f.tparams)
        self._bodies: Dict[str, cparse.SBlock] = {}
        self._summaries: Dict[tuple, "_CudaFn"] = {}
        self._in_progress: set = set()

    def _load(self, src, rel, path, seen, names) -> None:
        if rel in seen:
            return
        seen.add(rel)
        if path is not None:
            for inc in _INCLUDE_RE.findall(src):
                p = path.parent / inc
                if p.is_file():
                    self._load(p.read_text(), posixpath.normpath(
                        posixpath.join(posixpath.dirname(rel), inc)), p, seen, names)
        self.units[rel] = cparse.lex(src)
        self.typedefs.update(cparse.typedef_types(src))
        names |= cparse.collect_typedefs(src)
        self.structs.update(cparse.struct_fields(src))
        for k, (v, _line) in cparse.parse_defines(src).items():
            self.consts[k] = (v, None)
        self.consts.update(cparse.parse_constexpr_types(src))
        for f in cparse.parse_functions(src):
            if f.body is not None:
                self.functions[f.name] = (f, rel)

    def body(self, name: str) -> cparse.SBlock:
        if name not in self._bodies:
            fn, unit = self.functions[name]
            self._bodies[name] = cparse.parse_body(
                self.units[unit][0], fn.body, self.type_names, self.templates)
        return self._bodies[name]

    def resolve(self, t: cparse.CType, tenv=None) -> cparse.CType:
        """Template type parameters and typedef names resolved to their
        type (pointer depth kept)."""
        for _ in range(8):
            if not t.base.startswith("named:"):
                return t
            nm = t.base[6:]
            b = (tenv or {}).get(nm)
            if isinstance(b, cparse.CType):
                t = cparse.CType(b.base, b.width, b.signed, b.ptr + t.ptr, b.boolean)
                continue
            alias = self.typedefs.get(nm)
            if alias is None:
                return t
            t = cparse.CType(alias.base, alias.width, alias.signed,
                             alias.ptr + t.ptr, alias.boolean)
        return t

    def fields_of(self, tname: str):
        if tname in _VECTOR_TYPES:
            w, signed = (64, tname.startswith("long")) if "longlong" in tname \
                else (32, tname.startswith("int"))
            return [(f, cparse.CType("int", w, signed), ())
                    for f in _VECTOR_TYPES[tname]]
        return self.structs.get(tname)

    def top_of(self, t: cparse.CType, tenv=None, dims=(), _depth=0):
        """The value a declaration of type `t` holds before anything is
        known: the type's full range, a struct of such fields, an array
        of such elements, or a pointer."""
        if dims:
            inner = self.top_of(t, tenv, dims[1:], _depth)
            n = self.dim(dims[0])
            return _ca([inner] * n) if n else CA(inner)
        t = self.resolve(t, tenv)
        if t.ptr > 0:
            return CP(cparse.CType(t.base, t.width, t.signed, t.ptr - 1,
                                   t.boolean))
        if t.base == "int":
            return CI(_trange(t), t)
        if t.base.startswith("named:") and _depth < 8:
            fields = self.fields_of(t.base[6:])
            if fields is not None:
                return CS(t.base[6:], tuple(sorted(
                    (f, self.top_of(ft, tenv, fd, _depth + 1))
                    for f, ft, fd in fields)))
        return CI(_trange(_U64), _U64, opaque=True)

    def zero_of(self, t: cparse.CType, tenv=None, dims=(), _depth=0):
        """The value of a value-initialised `t` (an aggregate's missing
        members)."""
        if dims:
            inner = self.zero_of(t, tenv, dims[1:], _depth)
            n = self.dim(dims[0])
            return _ca([inner] * n) if n else CA(inner)
        t = self.resolve(t, tenv)
        if t.ptr > 0:
            return self.top_of(t, tenv)
        if t.base == "int":
            return CI(Iv(0, 0), t)
        if t.base.startswith("named:") and _depth < 8:
            fields = self.fields_of(t.base[6:])
            if fields is not None:
                return CS(t.base[6:], tuple(sorted(
                    (f, self.zero_of(ft, tenv, fd, _depth + 1))
                    for f, ft, fd in fields)))
        return self.top_of(t, tenv)

    def dim_value(self, d, tenv=None) -> Optional[int]:
        """An array bound's value where it is a constant (a number, a
        constant of the file or a template argument), else None."""
        if d is None or isinstance(d, int):
            return d
        d = d.strip()
        if d.isdigit():
            return int(d)
        if isinstance((tenv or {}).get(d), int):
            return tenv[d]
        return self.consts[d][0] if d in self.consts else None

    def dim(self, d, tenv=None) -> Optional[int]:
        """An array bound's value where it is a short constant (an array
        tracked element by element), else None."""
        v = self.dim_value(d, tenv)
        return v if v is not None and 0 < v <= _ITEMS_MAX else None

    def sizeof(self, t: cparse.CType, tenv=None, _depth=0) -> int:
        """Bytes of a value of type `t` (an address offset's scale)."""
        t = self.resolve(t, tenv)
        if t.ptr:
            return 8
        if t.base in ("int", "float"):
            return max(1, (t.width or 8) // 8)
        if t.base.startswith("named:") and _depth < 8:
            fields = self.fields_of(t.base[6:])
            if fields:
                total = 0
                for _f, ft, fd in fields:
                    n = 1
                    for d in fd:
                        n *= self.dim_value(d, tenv) or 1
                    total += n * self.sizeof(ft, tenv, _depth + 1)
                return total
        return 1

    def const_targ(self, a, tenv):
        """One template argument's value: an int, or a CType."""
        if isinstance(a, cparse.Num):
            return a.v
        if isinstance(a, cparse.Name):
            if isinstance((tenv or {}).get(a.n), int):
                return tenv[a.n]
            if a.n in self.consts:
                return self.consts[a.n][0]
            return cparse.CType(f"named:{a.n}")
        if isinstance(a, cparse.CType):
            return self.resolve(a, tenv)
        return None

    def summary(self, name: str, targs: tuple) -> Optional["_CudaFn"]:
        """The callee (at these template arguments) analysed at its
        declared entry ranges (memoized; None on recursion)."""
        key = (name, targs)
        if key in self._summaries:
            return self._summaries[key]
        if key in self._in_progress:
            return None
        self._in_progress.add(key)
        fn, unit = self.functions[name]
        fa = _CudaFn(self, fn, unit, dict(zip([p for _k, p in fn.tparams], targs)))
        fa.suppress = True  # findings come from the function's own run
        fa.run()
        self._in_progress.discard(key)
        self._summaries[key] = fa
        return fa


@functools.lru_cache(maxsize=16)
def _cuda_file(src: str, rel: str, path: Optional[str]) -> _CudaFile:
    return _CudaFile(src, rel, pathlib.Path(path) if path else None)


class _CudaFn:
    """Width-aware interval interpretation of one device function (at one
    template instantiation)."""

    def __init__(self, cf: _CudaFile, fn: cparse.CFunc, unit: str,
                 tenv: Optional[dict] = None) -> None:
        self.cf = cf
        self.fn = fn
        self.unit = unit
        self.anns = cf.units[unit][1]
        self.tenv = dict(tenv or {})
        self.scope = fn.name + (
            "<" + ",".join(str(v) if isinstance(v, int) else _tname(v)
                           if v.base == "int" else v.base[6:]
                           for v in self.tenv.values()) + ">"
            if self.tenv else "")
        self.findings: List[Finding] = []
        self.checked_ops = 0
        self.suppress = False
        self.ret = None
        self.ret_type = cf.resolve(fn.ret, self.tenv)
        self.out_params: Dict[str, object] = {}
        self.declared: Dict[str, Iv] = {}
        self._frames: List[list] = []  # [return value, return envs] per body
        self._loops: List[dict] = []   # break / continue envs per loop

    # --- reporting ---

    def _flag(self, code: str, line: int, subject: str, msg: str) -> None:
        if self.suppress:
            return
        for ln in (line, self.fn.line):
            a = ann_mod.lookup(self.anns, ln)
            if a is not None and (a.allows(code) or a.allows("absint")):
                return
        f = Finding("absint", code, self.unit, line, self.scope, subject, msg)
        if f not in self.findings:
            self.findings.append(f)

    def _line_ranges(self, line: int) -> Dict[str, Iv]:
        a = ann_mod.lookup(self.anns, line)
        if a is None or "range" not in a.clauses:
            return {}
        try:
            return parse_ranges(a)
        except ValueError as e:
            self._flag("bad-range", line, "range", str(e))
            return {}

    # --- entry ---

    def _builtins(self) -> dict:
        mt = _MAX_THREADS
        if self.fn.launch_bounds is not None:
            b = self.fn.launch_bounds
            mt = int(b.rstrip("uUlL"), 0) if b[:1].isdigit() else \
                self.cf.consts.get(b, (_MAX_THREADS, None))[0]

        def dim3(x, y, z):
            return CS("dim3", tuple(sorted(
                (f, CI(Iv(lo, hi), _U32))
                for f, (lo, hi) in zip("xyz", (x, y, z)))))

        return {
            "threadIdx": dim3((0, mt - 1), (0, mt - 1), (0, 63)),
            "blockDim": dim3((1, mt), (1, mt), (1, 64)),
            "blockIdx": dim3((0, (1 << 31) - 2), (0, 65534), (0, 65534)),
            "gridDim": dim3((1, (1 << 31) - 1), (1, 65535), (1, 65535)),
        }

    def _contract(self) -> Dict[str, Iv]:
        """The `range=` on the declaration's head: on the line of its
        name, or bound to any line from its `template` header on."""
        first = self.fn.head_line or self.fn.line
        for ln in range(self.fn.line, first - 1, -1):
            got = self._line_ranges(ln)
            if got:
                return got
        return {}

    def run(self) -> None:
        self.declared = self._contract()
        env: Dict[str, object] = self._builtins()
        for p in self.fn.params:
            if p.name:
                env[p.name] = self.cf.top_of(p.ctype, self.tenv)
        for path, iv in self.declared.items():
            segs = tuple(path.split("."))
            if segs[0] in env:
                env[segs[0]] = _path_set(
                    env[segs[0]], segs[1:],
                    lambda v: CI(Iv(iv.lo, iv.hi), v.t) if isinstance(v, CI) else v)
        env["$facts"] = frozenset()
        env["$defs"] = frozenset()
        self._frames.append([None, []])
        final = self._exec(self.cf.body(self.fn.name), env)
        self.ret, ret_envs = self._frames.pop()
        for r in ret_envs:  # every path out of the function
            final = self._join(final, r)
        for p in self.fn.params:
            if p.ref and not p.const and final is not None and p.name in final:
                self.out_params[p.name] = final[p.name]

    # --- values ---

    def _join(self, a: Optional[dict], b: Optional[dict]) -> Optional[dict]:
        if a is None:
            return None if b is None else dict(b)
        if b is None:
            return dict(a)
        out = {}
        for k in a.keys() & b.keys():
            if k in ("$facts", "$defs"):
                out[k] = a[k] & b[k]
            else:
                out[k] = _join_vals(a[k], b[k])
        return out

    def _join_all(self, envs) -> Optional[dict]:
        out = None
        for e in envs:
            out = self._join(out, e) if out is not None else (
                None if e is None else dict(e))
        return out

    def _widen_val(self, old, new):
        if isinstance(old, CI) and isinstance(new, CI):
            r = _trange(new.t)
            lo = r.lo if new.iv.lo < old.iv.lo else new.iv.lo
            hi = r.hi if new.iv.hi > old.iv.hi else new.iv.hi
            return CI(Iv(lo, hi), new.t, new.opaque)
        if isinstance(old, CS) and isinstance(new, CS) and old.tname == new.tname:
            do = dict(old.fields)
            return CS(new.tname, tuple(sorted(
                (k, self._widen_val(do.get(k), v)) for k, v in new.fields)))
        if isinstance(old, CA) and isinstance(new, CA):
            if old.items is not None and new.items is not None and \
                    len(old.items) == len(new.items):
                return _ca([self._widen_val(x, y)
                            for x, y in zip(old.items, new.items)])
            return CA(self._widen_val(old.elem, new.elem))
        return new

    def _widen(self, old: dict, new: dict) -> dict:
        return {k: v if k.startswith("$") or k not in old
                else self._widen_val(old[k], v) for k, v in new.items()}

    def _convert(self, v, t: cparse.CType, line: int, explicit: bool):
        """`v` converted to type `t` (an initialisation, an assignment, an
        argument, a return or a cast). An implicit conversion that may
        truncate is a `limb-overflow`; an explicit cast wraps as the
        source says."""
        t = self.cf.resolve(t, self.tenv)
        if t.ptr > 0:
            return v if isinstance(v, CP) else self.cf.top_of(t, self.tenv)
        if t.base != "int":
            return v if isinstance(v, (CS, CA, CL)) else self.cf.top_of(t, self.tenv)
        if not isinstance(v, CI):
            return CI(_trange(t), t)
        if t.boolean:
            lo = 0 if v.iv.lo <= 0 <= v.iv.hi else 1
            hi = 0 if v.iv.lo == v.iv.hi == 0 else 1
            return CI(Iv(lo, hi), t)
        r = _trange(t)
        if r.lo <= v.iv.lo and v.iv.hi <= r.hi:
            if not explicit and ((v.t.width or 0), v.t.signed, v.t.boolean) != (
                    t.width, t.signed, t.boolean):
                self.checked_ops += 1  # a conversion between types, proven exact
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

    def _arith(self, op: str, a: CI, b: CI, line: int,
               floor0: bool = False) -> CI:
        """`floor0`: the operands are known to satisfy a >= b (a guard
        the caller read), so a difference is not below 0."""
        if op in ("<<", ">>"):
            t = self._promote(a.t)
        else:
            t = self._common(a.t, b.t)
        r = _trange(t)
        x, y = a.iv, b.iv
        if a.opaque or b.opaque:
            self._flag("c-parse", line, op,
                       f"an operand of {op} is a value the front end cannot "
                       "read (an unknown call or name)")
            return CI(r, t, opaque=True)
        if op in ("+", "-", "*", "<<"):
            if op == "+":
                lo, hi, what = x.lo + y.lo, x.hi + y.hi, "add"
            elif op == "-":
                lo, hi, what = x.lo - y.hi, x.hi - y.lo, "subtract"
                if floor0:
                    lo = max(lo, 0)
            elif op == "*":
                cs = (x.lo * y.lo, x.lo * y.hi, x.hi * y.lo, x.hi * y.hi)
                lo, hi, what = min(cs), max(cs), "multiply"
            else:
                if y.lo < 0 or y.hi >= t.width or x.lo < 0:
                    lo, hi = r.lo - 1, r.hi + 1
                else:
                    lo, hi = x.lo << y.lo, x.hi << y.hi
                what = "left shift"
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
        if op in ("/", "%"):
            # A divisor that may be 0, or INT_MIN / -1, has no defined
            # quotient.
            self.checked_ops += 1
            if y.lo <= 0 <= y.hi or (t.signed and x.lo <= r.lo and y.lo <= -1 <= y.hi):
                self._flag("limb-overflow", line, op,
                           f"divisor may be 0 (or the quotient leave the type): "
                           f"[{x.lo},{x.hi}] {op} [{y.lo},{y.hi}] as {_tname(t)}")
                return CI(r, t)
            if x.lo < 0 or y.lo < 0:
                return CI(r, t)
            if op == "/":
                return CI(Iv(x.lo // y.hi, x.hi // y.lo), t)
            return CI(Iv(0, y.hi - 1), t)
        if x.lo < 0 or y.lo < 0:
            return CI(r, t)
        if op == ">>":
            return CI(Iv(x.lo >> min(y.hi, 1 << 16), x.hi >> y.lo), t)
        if op == "&":
            return CI(Iv(0, min(x.hi, y.hi)), t)
        if op in ("|", "^"):
            return CI(_bitlen_bound(x, y), t)
        return CI(r, t)

    _CMP = frozenset(("==", "!=", "<", ">", "<=", ">="))

    def _peek(self, e, env: dict):
        """`e`'s value, read without reporting, counting or changing env."""
        saved = (self.suppress, self.checked_ops)
        self.suppress = True
        try:
            return self._eval(e, dict(env))
        finally:
            self.suppress, self.checked_ops = saved

    def _comparable(self, a, b) -> bool:
        """Whether C compares `a` and `b` as the integers they hold (a
        negative value against an unsigned one does not)."""
        if not (isinstance(a, CI) and isinstance(b, CI)) or a.opaque or b.opaque:
            return False
        t = self._common(a.t, b.t)
        return t.signed or (a.iv.lo >= 0 and b.iv.lo >= 0)

    def _name(self, n: str, env: dict):
        if n in env:
            return env[n]
        if isinstance(self.tenv.get(n), int):
            v = self.tenv[n]
            return CI(Iv(v, v), _INT32)
        if n in ("true", "false"):
            b = int(n == "true")
            return CI(Iv(b, b), _BOOL_T)
        if n in self.cf.consts:
            v, t = self.cf.consts[n]
            if t is None:
                t = _U64 if v > 0x7FFFFFFF else _INT32
            return CI(Iv(v, v), t)
        if n in ("nullptr", "NULL"):
            return CP(cparse.CType("void"))
        if n == "warpSize":
            return CI(Iv(32, 32), _INT32)
        return CI(_trange(_U64), _U64, opaque=True)

    def _eval(self, e, env: dict):
        if isinstance(e, cparse.Num):
            return self._literal(e)
        if isinstance(e, cparse.Name):
            return self._name(e.n, env)
        if isinstance(e, cparse.Bin):
            return self._bin(e, env)
        if isinstance(e, cparse.Un):
            return self._unary(e, env)
        if isinstance(e, cparse.IncDec):
            old = self._eval(e.e, env)
            if not isinstance(old, CI):
                return old
            new = self._arith("+" if e.op == "++" else "-", old,
                              CI(Iv(1, 1), _INT32), e.line)
            self._store(e.e, new, env, e.line)
            return old if e.post else self._peek(e.e, env)
        if isinstance(e, cparse.Call):
            return self._call(e, env)
        if isinstance(e, cparse.Idx):
            bv = self._eval(e.base, env)
            iv = self._eval(e.idx, env)
            if isinstance(bv, CA):
                k = iv.iv.lo if isinstance(iv, CI) and iv.iv.lo == iv.iv.hi \
                    and not iv.opaque else None
                if bv.items is not None and k is not None and \
                        0 <= k < len(bv.items):
                    return bv.items[k]
                return bv.elem
            if isinstance(bv, CP):
                if isinstance(iv, CI):
                    self._offset(bv, iv, e.line, "+")
                return self.cf.top_of(bv.elem, self.tenv)
            return CI(_trange(_U64), _U64, opaque=True)
        if isinstance(e, cparse.Mem):
            bv = self._eval(e.base, env)
            if isinstance(bv, CS):
                v = bv.get(e.f)
                if v is not None:
                    return v
            if isinstance(bv, CP) and bv.elem.base.startswith("named:"):
                for f, ft, fd in self.cf.fields_of(bv.elem.base[6:]) or ():
                    if f == e.f:
                        return self.cf.top_of(ft, self.tenv, fd)
            return CI(_trange(_U64), _U64, opaque=True)
        if isinstance(e, cparse.Cast):
            v = self._eval(e.e, env)
            if e.ctype is None:
                return v
            return self._convert(v, e.ctype, e.line, explicit=True)
        if isinstance(e, cparse.Cond):
            self._eval(e.c, env)
            t_env = self._cond(dict(env), e.c, True)
            f_env = self._cond(dict(env), e.c, False)
            a = self._eval(e.a, t_env) if t_env is not None else None
            b = self._eval(e.b, f_env) if f_env is not None else None
            if a is None or b is None:
                return a if b is None else b
            if isinstance(a, CI) and isinstance(b, CI):
                t = self._common(a.t, b.t)
                return CI(a.iv.join(b.iv), t, a.opaque or b.opaque)
            return _join_vals(a, b)
        if isinstance(e, cparse.Assign):
            return self._assign(e, env)
        if isinstance(e, cparse.Compound):
            return self._aggregate(cparse.CType(f"named:{e.tname}"), e.init,
                                   env, e.line)
        if isinstance(e, cparse.Lambda):
            return CL(e)
        return CI(_trange(_U64), _U64, opaque=True)

    def _bin(self, e: cparse.Bin, env: dict):
        if e.op in ("&&", "||"):
            lv = self._eval(e.l, env)
            r_env = self._cond(dict(env), e.l, e.op == "&&")
            rv = self._eval(e.r, r_env) if r_env is not None else None
            lb = lv.iv if isinstance(lv, CI) and not lv.opaque else BOOL
            rb = rv.iv if isinstance(rv, CI) and not rv.opaque else BOOL
            l_t, l_f = lb.lo > 0 or lb.hi < 0, lb.lo == lb.hi == 0
            r_t, r_f = rb.lo > 0 or rb.hi < 0, rb.lo == rb.hi == 0
            if e.op == "&&":
                v = Iv(0, 0) if l_f or (rv is not None and r_f) else \
                    Iv(1, 1) if l_t and r_t else BOOL
            else:
                v = Iv(1, 1) if l_t or (rv is not None and r_t) else \
                    Iv(0, 0) if l_f and r_f else BOOL
            return CI(v, _BOOL_T)
        lv, rv = self._eval(e.l, env), self._eval(e.r, env)
        if e.op in self._CMP:
            if self._comparable(lv, rv):
                return CI(_cmp(e.op, lv.iv, rv.iv), _BOOL_T)
            return CI(BOOL, _BOOL_T)
        if isinstance(lv, CP) and isinstance(rv, CI) and e.op in ("+", "-"):
            self._offset(lv, rv, e.line, e.op)
            return lv  # pointer arithmetic keeps the element type
        if isinstance(rv, CP) and isinstance(lv, CI) and e.op == "+":
            self._offset(rv, lv, e.line, "+")
            return rv
        if isinstance(lv, CI) and isinstance(rv, CI):
            if e.op == "*":
                q = self._quotient_product(e, lv, rv, env)
                if q is not None:
                    return q
            return self._arith(e.op, lv, rv, e.line,
                               floor0=e.op == "-" and self._has_fact(env, e.l, e.r))
        self._flag("c-parse", e.line, e.op,
                   f"an operand of {e.op} is not an integer the front end reads")
        return CI(_trange(_U64), _U64, opaque=True)

    def _offset(self, p: CP, i: CI, line: int, op: str) -> None:
        """`i` elements of `p`'s type past (or before) `p`: the byte offset
        stays within the 64-bit address difference."""
        if i.opaque:
            self._flag("c-parse", line, op, "an address offset the front end "
                       "cannot read")
            return
        size = self.cf.sizeof(p.elem, self.tenv)
        lo, hi = (i.iv.lo, i.iv.hi) if op == "+" else (-i.iv.hi, -i.iv.lo)
        self.checked_ops += 1
        if hi * size > (1 << 63) - 1 or lo * size < -(1 << 63):
            self._flag("limb-overflow", line, op,
                       f"address offset may leave the 64-bit range: "
                       f"[{i.iv.lo},{i.iv.hi}] elements of {size} bytes")

    def _quotient_product(self, e: cparse.Bin, lv: CI, rv: CI, env: dict):
        """(x / y) * y lies in [0, x] for x >= 0, y >= 1: a product whose
        one factor was assigned the quotient of the other's value."""
        for fac, other, ov in ((e.l, e.r, rv), (e.r, e.l, lv)):
            k = self._key(fac, env)
            d = self._def_of(env, k[0]) if k is not None else None
            if d is None or not (isinstance(d, cparse.Bin) and d.op == "/"):
                continue
            ky, ko = self._key(d.r, env), self._key(other, env)
            if ky is None or ko is None or ky[0] != ko[0]:
                continue
            xv = self._peek(d.l, env)
            if isinstance(xv, CI) and not xv.opaque and xv.iv.lo >= 0 \
                    and ov.iv.lo >= 1:
                self.checked_ops += 1
                return CI(Iv(0, xv.iv.hi), self._common(lv.t, rv.t))
        return None

    def _unary(self, e: cparse.Un, env: dict):
        v = self._eval(e.e, env)
        if e.op == "!":
            if isinstance(v, CI) and not v.opaque:
                if v.iv.lo > 0 or v.iv.hi < 0:
                    return CI(Iv(0, 0), _BOOL_T)
                if v.iv.lo == v.iv.hi == 0:
                    return CI(Iv(1, 1), _BOOL_T)
            return CI(BOOL, _BOOL_T)
        if e.op == "*":
            if isinstance(v, CP):
                return self.cf.top_of(v.elem, self.tenv)
            return v.elem if isinstance(v, CA) else v
        if e.op == "&":
            if isinstance(v, CI):
                return CP(v.t)
            if isinstance(v, CS):
                return CP(cparse.CType(f"named:{v.tname}"))
            return CP(_U64)
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

    def _aggregate(self, t: cparse.CType, init, env: dict, line: int, dims=()):
        """An aggregate initialiser's value: each item converted to its
        member (or element) in order, the members it leaves out zero."""
        items = init.items if isinstance(init, cparse.InitList) else (init,)
        if dims:
            vals = [self._aggregate(t, it, env, line, dims[1:])
                    if isinstance(it, cparse.InitList) or dims[1:] else
                    self._convert(self._eval(it, env), t, line, explicit=False)
                    for it in items]
            n = self.cf.dim(dims[0])
            if n is not None and len(vals) <= n:
                zero = self.cf.zero_of(t, self.tenv, dims[1:])
                return _ca(vals + [zero] * (n - len(vals)))
            out = None if vals else self.cf.zero_of(t, self.tenv, dims[1:])
            for v in vals:
                out = _join_vals(out, v)
            return CA(out)
        rt = self.cf.resolve(t, self.tenv)
        fields = (self.cf.fields_of(rt.base[6:])
                  if rt.base.startswith("named:") and not rt.ptr else None)
        if fields is None:
            if not items:
                return self.cf.zero_of(rt, self.tenv)
            if isinstance(items[0], cparse.InitList):
                return self._aggregate(rt, items[0], env, line)
            return self._convert(self._eval(items[0], env), rt, line,
                                 explicit=False)
        vals = []
        for k, (f, ft, fd) in enumerate(fields):
            if k < len(items):
                it = items[k]
                if isinstance(it, cparse.InitList) or fd:
                    v = self._aggregate(ft, it, env, line, fd)
                else:
                    v = self._convert(self._eval(it, env), ft, line,
                                      explicit=False)
            else:
                v = self.cf.zero_of(ft, self.tenv, fd)
            vals.append((f, v))
        return CS(rt.base[6:], tuple(sorted(vals)))

    # --- facts: what a guard says of two expressions ---

    def _key(self, e, env: dict):
        """(canonical key, names read, reads memory) of a pure expression,
        None otherwise. Integer casts that keep the value are transparent."""
        names: set = set()
        mem = [False]

        def k(x):
            if isinstance(x, cparse.Num):
                return ("c", x.v)
            if isinstance(x, cparse.Name):
                names.add(x.n)
                return ("n", x.n)
            if isinstance(x, cparse.Mem):
                b = k(x.base)
                return None if b is None else ("m", b, x.f)
            if isinstance(x, cparse.Idx):
                b, i = k(x.base), k(x.idx)
                if b is None or i is None:
                    return None
                if isinstance(self._peek(x.base, env), CP):
                    mem[0] = True
                return ("i", b, i)
            if isinstance(x, cparse.Cast):
                if x.ctype is None:
                    return k(x.e)
                t = self.cf.resolve(x.ctype, self.tenv)
                if t.ptr or t.base != "int" or t.boolean:
                    return None
                inner = self._peek(x.e, env)
                r = _trange(t)
                if not (isinstance(inner, CI) and not inner.opaque
                        and r.lo <= inner.iv.lo and inner.iv.hi <= r.hi):
                    return None
                return k(x.e)
            if isinstance(x, cparse.Bin) and x.op not in ("&&", "||"):
                a, b = k(x.l), k(x.r)
                return None if a is None or b is None else ("b", x.op, a, b)
            if isinstance(x, cparse.Un) and x.op in ("-", "~", "!", "*"):
                if x.op == "*":
                    mem[0] = True
                a = k(x.e)
                return None if a is None else ("u", x.op, a)
            return None

        key = k(e)
        return None if key is None else (key, frozenset(names), mem[0])

    def _add_fact(self, env: dict, ge, le) -> dict:
        """Record ge >= le."""
        a, b = self._key(ge, env), self._key(le, env)
        if a is None or b is None:
            return env
        env = dict(env)
        env["$facts"] = env.get("$facts", frozenset()) | {
            (a[0], b[0], a[1] | b[1], a[2] or b[2])}
        return env

    def _has_fact(self, env: dict, ge, le) -> bool:
        if not env.get("$facts"):
            return False
        a, b = self._key(ge, env), self._key(le, env)
        return a is not None and b is not None and any(
            f[0] == a[0] and f[1] == b[0] for f in env["$facts"])

    def _def_of(self, env: dict, key):
        for d in env.get("$defs", ()):
            if d[0] == key:
                return d[1]
        return None

    def _add_def(self, env: dict, target, value) -> None:
        """Remember that the path `target` holds the pure expression
        `value` (until a name either reads is stored to)."""
        tk = self._key(target, env)
        if tk is None or _path_of(target) is None:
            return
        vk = self._key(value, env)
        if vk is None or _path_of(target)[0] in vk[1]:
            return
        env["$defs"] = env.get("$defs", frozenset()) | {
            (tk[0], value, vk[1] | {_path_of(target)[0]}, vk[2])}

    def _invalidate(self, env: dict, name: Optional[str]) -> None:
        """A store to `name` (None: to memory) ends every fact and
        definition that reads it."""
        if name is None:
            keep = lambda f: not f[3]  # noqa: E731
        else:
            keep = lambda f: name not in f[2]  # noqa: E731
        if env.get("$facts"):
            env["$facts"] = frozenset(f for f in env["$facts"] if keep(f))
        if env.get("$defs"):
            env["$defs"] = frozenset(d for d in env["$defs"] if keep(d))

    # --- calls ---

    def _call(self, e: cparse.Call, env: dict):
        fn = e.fn
        if isinstance(fn, cparse.Name) and isinstance(env.get(fn.n), CL):
            return self._call_lambda(env[fn.n].lam, e, env)
        name = fn.n.split("::")[-1] if isinstance(
            fn, (cparse.Name, cparse.TplName)) else None
        if isinstance(fn, cparse.Mem):
            self._eval(fn.base, env)  # a method (`grid.sync()`)
        args = [self._eval(a, env) for a in e.args]
        if name in _ATOMICS and args and isinstance(args[0], CP):
            self._invalidate(env, None)
            a0 = e.args[0]
            if isinstance(a0, cparse.Un) and a0.op == "&" and \
                    _path_of(a0.e) is not None:  # atomicOr(&local, ...)
                self._store(a0.e, self.cf.top_of(args[0].elem, self.tenv),
                            env, e.line, explicit=True)
            return self.cf.top_of(args[0].elem, self.tenv)
        if name in _SHUFFLES and len(args) >= 2 and isinstance(args[1], CI):
            return args[1]
        if name in _VOTES:
            return CI(BOOL, _INT32)
        if name == "__ballot_sync":
            return CI(_trange(_U32), _U32)
        if name in _RESULT_RANGES:
            return CI(Iv(0, _RESULT_RANGES[name]), _INT32)
        if name in _REDUCE_BITS and len(args) >= 2 and isinstance(args[1], CI):
            v = args[1]
            return CI(_bitlen_bound(v.iv, v.iv) if v.iv.lo >= 0
                      else _trange(v.t), v.t)
        if name in _LOADS and args and isinstance(args[0], CP):
            return self.cf.top_of(args[0].elem, self.tenv)
        if name in _VOID_CALLS:
            self._invalidate(env, None)
            return CI(Iv(0, 0), _INT32)
        if name and name.startswith("make_") and name[5:] in _VECTOR_TYPES:
            fields = self.cf.fields_of(name[5:])
            return CS(name[5:], tuple(sorted(
                (f, self._convert(a, ft, e.line, explicit=False))
                for (f, ft, _d), a in zip(fields, args))))
        if name in ("min", "max") and len(args) == 2 and all(
                isinstance(a, CI) for a in args):
            a, b = args
            pick = min if name == "min" else max
            return CI(Iv(pick(a.iv.lo, b.iv.lo), pick(a.iv.hi, b.iv.hi)),
                      self._common(a.t, b.t))
        if name not in self.cf.functions:
            self._invalidate(env, None)
            return CI(_trange(_U64), _U64, opaque=True)
        callee, _unit = self.cf.functions[name]
        targs = self._targs(callee, fn, args)
        summ = self.cf.summary(name, targs) if targs is not None else None
        ctenv = dict(zip([p for _k, p in callee.tparams], targs or ()))
        declared = summ.declared if summ is not None else {}
        for p, a in zip(callee.params, args):
            mine = {path: d for path, d in declared.items()
                    if path.split(".")[0] == p.name}
            for path, d in mine.items():
                v = _path_get(a, path.split(".")[1:])
                while isinstance(v, CA):
                    v = v.elem
                if isinstance(v, CI) and not v.opaque:
                    self.checked_ops += 1
                    if v.iv.lo < d.lo or v.iv.hi > d.hi:
                        self._flag(
                            "range-obligation", e.line, f"{name}.{path}",
                            f"argument [{v.iv.lo},{v.iv.hi}] may exceed "
                            f"{name}()'s declared range {path}:[{d.lo},{d.hi}]")
            if p.name not in mine and not p.ref and not p.ctype.ptr:
                pt = self.cf.resolve(p.ctype, ctenv)
                if pt.base == "int" and not pt.ptr:
                    self._convert(a, pt, e.line, explicit=False)
        self._invalidate(env, None)  # a callee may store through a pointer
        if summ is None:
            return self.cf.top_of(callee.ret, ctenv)
        # Reference parameters come back with the callee's final values.
        for p, arg in zip(callee.params, e.args):
            if p.ref and not p.const and p.name in summ.out_params:
                self._store(arg, summ.out_params[p.name], env, e.line,
                            explicit=True)
        if summ.ret is None:
            return self.cf.top_of(summ.ret_type, ctenv)
        return summ.ret

    def _targs(self, callee: cparse.CFunc, fn, args) -> Optional[tuple]:
        """The template arguments of a call: explicit (`f<5>(x)`), deduced
        from the arguments' types (`ld(p)`), or, for a parameter neither
        gives, the caller's own argument of that name."""
        if not callee.tparams:
            return ()
        given = list(fn.args) if isinstance(fn, cparse.TplName) else []
        out = []
        for k, (kind, pname) in enumerate(callee.tparams):
            if k < len(given):
                out.append(self.cf.const_targ(given[k], self.tenv))
                continue
            got = None
            if kind == "type":
                for p, a in zip(callee.params, args):
                    if p.ctype.base == f"named:{pname}":
                        if isinstance(a, CP) and p.ctype.ptr:
                            got = cparse.CType(a.elem.base, a.elem.width,
                                               a.elem.signed, a.elem.ptr - p.ctype.ptr + 1,
                                               a.elem.boolean)
                        elif isinstance(a, CI):
                            got = a.t
                        elif isinstance(a, CS):
                            got = cparse.CType(f"named:{a.tname}")
                        break
            elif pname in self.tenv:
                got = self.tenv[pname]
            if got is None:
                return None
            out.append(got)
        return tuple(out)

    def _call_lambda(self, lam: cparse.Lambda, e: cparse.Call, env: dict):
        """A lambda's body read inline at its call, in the caller's frame
        (its captures are by reference)."""
        args = [self._eval(a, env) for a in e.args]
        local = dict(env)
        for p, a in zip(lam.params, args):
            pt = self.cf.resolve(p.ctype, self.tenv)
            local[p.name] = self._convert(a, pt, e.line, explicit=False) \
                if isinstance(a, CI) and pt.base == "int" else a
        self._frames.append([None, []])
        saved_loops, self._loops = self._loops, []
        try:
            out = self._exec(lam.body, local)
        finally:
            self._loops = saved_loops
            ret, renvs = self._frames.pop()
        final = self._join_all([out] + renvs)
        if final is not None:
            shadow = {p.name for p in lam.params}
            for k in list(env):
                if k in final and k not in shadow:
                    env[k] = final[k]
        return ret if ret is not None else CI(Iv(0, 0), _INT32)

    # --- stores ---

    def _lvalue(self, e, env: dict):
        """("local", root) for a local variable path, ("memory", element
        type) for a store through a pointer, or (None, None)."""
        if isinstance(e, cparse.Name):
            return ("local", e.n) if e.n in env else (None, None)
        if isinstance(e, cparse.Mem):
            kind, x = self._lvalue(e.base, env)
            if kind == "memory":
                return "memory", None
            if kind == "local":
                return kind, x
            bv = self._peek(e.base, env)
            return ("memory", None) if isinstance(bv, CP) else (None, None)
        if isinstance(e, cparse.Idx):
            bv = self._peek(e.base, env)
            if isinstance(bv, CP):
                return "memory", bv.elem
            return self._lvalue(e.base, env)
        if isinstance(e, cparse.Un) and e.op == "*":
            bv = self._peek(e.e, env)
            return "memory", bv.elem if isinstance(bv, CP) else None
        return None, None

    def _update(self, e, fn, env: dict) -> None:
        if isinstance(e, cparse.Name):
            env[e.n] = fn(env[e.n])
        elif isinstance(e, cparse.Mem):
            f = e.f
            self._update(e.base, lambda b: b.with_field(f, fn(b.get(f)))
                         if isinstance(b, CS) and b.get(f) is not None else b, env)
        elif isinstance(e, cparse.Idx):
            k = self._index(e.idx, env)

            def upd(b):
                if not isinstance(b, CA):
                    return b
                if b.items is None:
                    return CA(_join_vals(b.elem, fn(b.elem)))
                if k is not None and 0 <= k < len(b.items):
                    items = list(b.items)
                    items[k] = fn(items[k])
                    return _ca(items)
                return _ca([_join_vals(x, fn(x)) for x in b.items])

            self._update(e.base, upd, env)

    def _index(self, ix, env: dict) -> Optional[int]:
        """A subscript's value where it is one number."""
        v = self._peek(ix, env)
        if isinstance(v, CI) and not v.opaque and v.iv.lo == v.iv.hi:
            return v.iv.lo
        return None

    def _store(self, target, val, env: dict, line: int,
               explicit: bool = False) -> None:
        """Assign `val` to an lvalue: a local variable, a member or an
        element of one (an array keeps the hull of what it was given), or
        memory through a pointer (converted to its element type; memory
        is not tracked)."""
        kind, x = self._lvalue(target, env)
        if kind == "local":
            def leaf(old):
                if isinstance(old, CI):
                    return self._convert(val, old.t, line, explicit)
                return val

            self._update(target, leaf, env)
            self._invalidate(env, x)
            path = _path_of(target)
            for name, iv in self._line_ranges(line).items():
                if path is not None and name == ".".join(path):
                    env[x] = _path_set(
                        env[x], path[1:],
                        lambda v: CI(Iv(iv.lo, iv.hi), v.t) if isinstance(v, CI) else v)
        elif kind == "memory":
            if isinstance(x, cparse.CType):
                t = self.cf.resolve(x, self.tenv)
                if t.base == "int" and not t.ptr:
                    self._convert(val, t, line, explicit)
            self._invalidate(env, None)
        else:
            self._eval(target, env)

    def _assign(self, e: cparse.Assign, env: dict):
        val = self._eval(e.value, env)
        if e.op != "=":
            cur = self._eval(e.target, dict(env))
            if isinstance(cur, CI) and isinstance(val, CI):
                val = self._arith(
                    e.op[:-1], cur, val, e.line,
                    floor0=e.op == "-=" and self._has_fact(env, e.target, e.value))
            elif isinstance(cur, CP):
                val = cur
        self._store(e.target, val, env, e.line)
        if e.op == "=":
            self._add_def(env, e.target, e.value)
        return val

    # --- conditions ---

    def _cond(self, env: Optional[dict], c, truth: bool) -> Optional[dict]:
        """`env` where `c` evaluates to `truth`; None where it cannot."""
        if env is None:
            return None
        v = self._peek(c, env)
        if isinstance(v, CI) and not v.opaque:
            if truth and v.iv.lo == v.iv.hi == 0:
                return None
            if not truth and (v.iv.lo > 0 or v.iv.hi < 0):
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
        if isinstance(c, cparse.Call) and isinstance(c.fn, cparse.Name) \
                and len(c.args) >= 2:
            # Every lane's predicate held (__all_sync true), or none did
            # (__any_sync false): so did this lane's.
            if c.fn.n == "__all_sync" and truth:
                return self._cond(env, c.args[1], True)
            if c.fn.n == "__any_sync" and not truth:
                return self._cond(env, c.args[1], False)
            return env
        if isinstance(c, cparse.Cast) and c.ctype is not None and (
                self.cf.resolve(c.ctype, self.tenv).boolean):
            return self._cond(env, c.e, truth)
        if isinstance(c, cparse.Bin) and c.op in self._CMP:
            op = c.op if truth else _NEG[c.op]
            lv, rv = self._peek(c.l, env), self._peek(c.r, env)
            if not self._comparable(lv, rv):
                return env
            env = self._narrow_expr(env, c.l, op, rv.iv)
            if env is None:
                return None
            env = self._narrow_expr(env, c.r, _SWAP[op], lv.iv)
            if env is None:
                return None
            if op in (">=", ">", "=="):
                env = self._add_fact(env, c.l, c.r)
            if op in ("<=", "<", "=="):
                env = self._add_fact(env, c.r, c.l)
            return env
        # Truthiness of a value, and of what it was defined as.
        env = self._narrow_expr(env, c, "!=" if truth else "==", Iv(0, 0))
        if env is None:
            return None
        k = self._key(c, env)
        d = self._def_of(env, k[0]) if k is not None else None
        if d is not None and isinstance(self._peek(c, env), CI) and \
                self._peek(c, env).t.boolean:
            return self._cond(env, d, truth)
        return env

    def _narrow_expr(self, env: dict, e, op: str, r: Iv) -> Optional[dict]:
        """`env` with `e`'s value narrowed by `e op r`: through a local
        variable path, an integer cast that keeps the value, or a right
        shift by a constant (`(x >> 58) == 0` bounds x below 2^58)."""
        if isinstance(e, cparse.Cast) and e.ctype is not None:
            t = self.cf.resolve(e.ctype, self.tenv)
            inner = self._peek(e.e, env)
            if t.base == "int" and not t.ptr and not t.boolean and isinstance(
                    inner, CI) and _trange(t).lo <= inner.iv.lo and \
                    inner.iv.hi <= _trange(t).hi:
                return self._narrow_expr(env, e.e, op, r)
            return env
        k = self._index(e.r, env) if isinstance(e, cparse.Bin) and e.op == ">>" \
            else None
        if k is not None and 0 <= k < 256:
            if op in ("<", "<=", "=="):
                hi = r.hi - (1 if op == "<" else 0)
                if hi < 0:
                    return None
                env = self._narrow_expr(env, e.l, "<=", Iv(((hi + 1) << k) - 1,
                                                           ((hi + 1) << k) - 1))
            if env is not None and op in (">", ">=", "=="):
                lo = r.lo + (1 if op == ">" else 0)
                env = self._narrow_expr(env, e.l, ">=", Iv(lo << k, lo << k))
            return env
        path = _path_of(e, lambda ix: self._index(ix, env))
        if path is None or path[0] not in env:
            return env
        cur = _path_get(env[path[0]], path[1:]) if len(path) > 1 else env[path[0]]
        if not isinstance(cur, CI) or cur.opaque:
            return env
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
        new = CI(Iv(lo, hi), cur.t)
        env[path[0]] = _path_set(env[path[0]], path[1:], lambda _v: new)
        if lo >= 1 and cur.iv.lo < 1:
            # A product of non-negative factors that is at least 1 has
            # factors that are at least 1 (`pairs = n * count`).
            k = self._key(e, env)
            d = self._def_of(env, k[0]) if k is not None else None
            if isinstance(d, cparse.Bin) and d.op == "*":
                for fac in (d.l, d.r):
                    fv = self._peek(fac, env)
                    if env is not None and isinstance(fv, CI) and fv.iv.lo >= 0:
                        env = self._narrow_expr(env, fac, ">=", Iv(1, 1))
        return env

    # --- statements ---

    def _assume(self, env: dict, line: int) -> dict:
        """A line's `range=` holds where the line starts too: it bounds a
        value the line reads (a loop-carried count a relation bounds)."""
        for path, iv in self._line_ranges(line).items():
            segs = tuple(path.split("."))
            if segs[0] not in env:
                continue

            def clamp(v, iv=iv):
                if not isinstance(v, CI):
                    return v
                lo, hi = max(v.iv.lo, iv.lo), min(v.iv.hi, iv.hi)
                return CI(Iv(lo, hi) if lo <= hi else Iv(iv.lo, iv.hi), v.t)

            env[segs[0]] = _path_set(env[segs[0]], segs[1:], clamp)
        return env

    def _exec(self, s, env: Optional[dict]) -> Optional[dict]:
        if env is None:
            return None
        if isinstance(s, cparse.SBlock):
            before = dict(env)
            declared: set = set()
            for st in s.stmts:
                if isinstance(st, cparse.SDecl):
                    declared |= {d[1] for d in st.decls}
                env = self._exec(st, env)
                if env is None:
                    return None
            return self._end_scope(env, before, declared)
        if isinstance(s, (cparse.SExpr, cparse.SDecl, cparse.SAsm)):
            env = self._assume(env, s.line)
        if isinstance(s, cparse.SDecl):
            for k, (ct, name, arrsize, init, line) in enumerate(s.decls):
                dims = s.dims[k] if s.dims else (
                    (arrsize,) if arrsize is not None else ())
                if dims:
                    v = (self._aggregate(ct, init, env, line, dims)
                         if init is not None else self.cf.top_of(ct, self.tenv, dims))
                elif init is None:
                    v = self.cf.top_of(ct, self.tenv)
                elif isinstance(init, cparse.InitList):
                    v = self._aggregate(ct, init, env, line)
                else:
                    val = self._eval(init, env)
                    v = val if self.cf.resolve(ct, self.tenv).base == "named:auto" \
                        else self._convert(val, ct, line, explicit=False)
                env[name] = v
                self._invalidate(env, name)
                if init is not None and not isinstance(init, cparse.InitList):
                    self._add_def(env, cparse.Name(name, line), init)
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
                if self._frames and len(self._frames) == 1 and isinstance(v, CI):
                    v = self._convert(v, self.ret_type, s.line, explicit=False)
                self._frames[-1][0] = _join_vals(self._frames[-1][0], v)
            self._frames[-1][1].append(dict(env))
            return None
        if isinstance(s, cparse.SIf):
            self._eval(s.c, env)
            t_env = self._cond(dict(env), s.c, True)
            e_env = self._cond(dict(env), s.c, False)
            t_out = self._exec(s.t, t_env)
            e_out = self._exec(s.e, e_env) if s.e is not None else e_env
            return self._join(t_out, e_out)
        if isinstance(s, cparse.SFor):
            before = dict(env)
            declared = {d[1] for st in s.init if isinstance(st, cparse.SDecl)
                        for d in st.decls}
            out = self._loop(s.init, s.c, s.step, s.body, env, s.line)
            return None if out is None else self._end_scope(out, before, declared)
        if isinstance(s, cparse.SWhile):
            return self._loop([], s.c, [], s.body, env, s.line)
        if isinstance(s, cparse.SDo):
            return self._loop([], s.c, [], s.body, env, s.line, do_while=True)
        if isinstance(s, (cparse.SBrk, cparse.SCont)):
            if not self._loops:
                raise cparse.CParseError("a break or continue outside a loop", s.line)
            self._loops[-1]["brk" if isinstance(s, cparse.SBrk) else "cont"].append(env)
            return None
        if isinstance(s, cparse.SAsm):
            # An asm output holds anything its register's width holds.
            for constraint, lv in s.outputs:
                bits = _ASM_BITS.get(constraint.lstrip("=+&")[:1], 64)
                self._store(lv, CI(Iv(0, (1 << bits) - 1),
                                   cparse.CType("int", bits, False)),
                            env, s.line, explicit=True)
            return env
        return env

    def _end_scope(self, env: dict, before: dict, declared: set) -> dict:
        """Leaving a block: its own declarations go, a name they shadowed
        comes back."""
        for name in declared:
            if name in before:
                env[name] = before[name]
            else:
                env.pop(name, None)
            self._invalidate(env, name)
        return env

    def _iterate(self, body, step, env: dict, exits: list) -> Optional[dict]:
        self._loops.append({"brk": [], "cont": []})
        try:
            out = self._exec(body, dict(env))
        finally:
            ctx = self._loops.pop()
        exits.extend(ctx["brk"])
        out = self._join_all([out] + ctx["cont"])
        for st in step:
            out = self._exec(st, out)
        return out

    def _loop(self, init, cond, step, body, env: dict, line: int,
              do_while: bool = False) -> Optional[dict]:
        """A loop: read one iteration at a time while its condition is
        decided (a constant trip count: `#pragma unroll` over a template
        constant, `for (int o = 16; o; o >>= 1)`), then to a fixed point
        with widening from where it is not."""
        for st in init:
            env = self._exec(st, env)
        exits: list = []
        cur, it = env, 0
        while cur is not None and it < _UNROLL_MAX:
            if cond is not None and (it > 0 or not do_while):
                v = self._peek(cond, cur)
                if not (isinstance(v, CI) and not v.opaque and v.iv.lo == v.iv.hi):
                    break
                self._eval(cond, cur)
                if v.iv.lo == 0:
                    exits.append(cur)
                    cur = None
                    break
            elif cond is None:
                break
            cur = self._iterate(body, step, cur, exits)
            it += 1
        if cur is not None:
            if do_while and it == 0:
                cur = self._iterate(body, step, cur, exits)
            exits.append(self._fixpoint(cond, step, body, cur, exits, line))
        return self._join_all(exits)

    def _fixpoint(self, cond, step, body, head: Optional[dict], exits: list,
                  line: int) -> Optional[dict]:
        if head is None:
            return None
        saved = (self.suppress, self.checked_ops)
        self.suppress = True
        entry = dict(head)
        try:
            for k in range(_CONVERGE_MAX):
                b_in = self._cond(dict(head), cond, True) if cond is not None \
                    else dict(head)
                out = self._iterate(body, step, b_in, []) if b_in is not None \
                    else None
                new = self._join(head, out)
                if k >= _C_WIDEN_AFTER:
                    new = self._widen(head, new)
                if new == head:
                    break
                head = new
            else:
                raise cparse.CParseError(
                    "a loop whose bounds reach no fixed point", line)
            # Narrowing: the loop entry joined with one pass from the
            # fixed point is again a fixed point, and gives back what a
            # widening took (a count the condition bounds).
            for _ in range(2):
                b_in = self._cond(dict(head), cond, True) if cond is not None \
                    else dict(head)
                out = self._iterate(body, step, b_in, []) if b_in is not None \
                    else None
                head = self._join(entry, out)
        finally:
            self.suppress, self.checked_ops = saved
        # The reporting pass, at the fixed point.
        if cond is not None:
            self._eval(cond, dict(head))
        b_in = self._cond(dict(head), cond, True) if cond is not None else dict(head)
        if b_in is not None:
            self._iterate(body, step, b_in, exits)
        return self._cond(dict(head), cond, False) if cond is not None else None


def _split_targs(spec: str):
    """`tile_scan<kRecLanes>` -> ("tile_scan", ("kRecLanes",))."""
    if "<" not in spec:
        return spec, ()
    name, rest = spec.split("<", 1)
    return name.strip(), tuple(a.strip() for a in rest.rstrip(">").split(",") if a.strip())


def prove_cuda_function(path, rel: str, fname: str,
                        source: Optional[str] = None
                        ) -> Tuple[List[Finding], int]:
    """(findings, checked-operation count) for one device function of a
    CUDA source, `name` or `name<args>` (a template at those arguments:
    numbers, constants of the file or type names). A function that is
    missing or outside the subset is a `c-parse` finding: the proof must
    not silently skip it."""
    try:
        src = pathlib.Path(path).read_text() if source is None else source
    except OSError as e:
        return ([Finding("absint", "c-parse", rel, 0, fname, fname,
                         f"cannot read source: {e}")], 0)
    cf = _cuda_file(src, rel, None if source is not None else str(path))
    name, targ_text = _split_targs(fname)
    entry = cf.functions.get(name)
    if entry is None:
        return ([Finding(
            "absint", "c-parse", rel, 0, fname, fname,
            f"listed function {fname} not found in {rel}: the proof must "
            "not silently skip it")], 0)
    fn, unit = entry
    targs = []
    for (kind, _p), text in zip(fn.tparams, targ_text):
        if kind == "int":
            v = int(text, 0) if text[:1].isdigit() else cf.consts.get(text, (None,))[0]
        else:
            v = cf.resolve(cparse.type_from_tokens(text.split(), 0))
        targs.append(v)
    if len(targs) != len(fn.tparams) or any(v is None for v in targs):
        return ([Finding(
            "absint", "c-parse", rel, fn.line, fname, fname,
            f"{fname}: give each template parameter of {name} an argument "
            "the file defines")], 0)
    try:
        cf.body(name)
    except cparse.CParseError as e:
        return ([Finding("absint", "c-parse", rel, e.line, fname, fname,
                         f"body outside the analysable subset: {e}")], 0)
    fa = _CudaFn(cf, fn, unit, dict(zip([p for _k, p in fn.tparams], targs)))
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
