"""Device hot-path lints for the port: hidden host syncs and
nondeterministic reductions.

Since the replica's commit thread, its store thread and the event loop
all launch kernels on one card, the split-phase window (dispatch a batch,
finish it later) overlaps only while nothing on those threads waits on
the card. A stray `.item()` or `.cpu()` waits for every kernel queued
before it and so serializes the window without failing anything. Two
passes, the port's counterparts of the reference package's jaxlint
`host-sync` and `reduction`:

  - `host-sync` — in every function of manifest.SYNCLINT_MODULES that is
    neither a seam (manifest.SYNCLINT_SEAM) nor declared host-only
    (manifest.SYNCLINT_HOST_ONLY, each with its reason):
      host-sync      `.item()`, `.cpu()`, a blocking `.to("cpu")`, a
                     blocking `.copy_` from the card into a host buffer,
                     and `.tolist()` / `.numpy()` / `bool()` / `int()` /
                     `float()` / `torch.equal()` / `torch.allclose()` on
                     a tensor on the card;
      device-branch  `if` / `while` / a conditional expression / `assert`
                     on a tensor on the card;
      unfenced-sync  `torch.cuda.synchronize()`, `Event.synchronize()`,
                     `Stream.synchronize()`;
      stale-seam     a seam or host-only entry naming no function.
  - `reduction` — in the same functions:
      float-dtype     a float dtype (`torch.float32`, `.float()`, ...):
                      the ledger's state is integer limbs;
      unordered-reduce `index_add_` / `scatter_add_` / `scatter_reduce_`
                      / `index_reduce_` / `index_put_(accumulate=True)` /
                      `sum` / `cumsum` / `mean` over float values: on CUDA
                      these accumulate with atomics or in an unfixed
                      order, so the bytes differ from run to run.

Which values lie on the card is a lexical taint per function, in three
points: DEVICE (a kernel wrapper's result, a torch constructor given a
`device=` other than "cpu", `.to(<device>)`, `.cuda()`, and what is
computed from those), HOST (`torch.from_numpy`, a constructor with
`pin_memory=` or no device, `.cpu()`), and unknown (parameters,
attributes of `self`). `.item()`, `.cpu()` and the synchronizes are
flagged whatever the receiver; the other forms need a DEVICE receiver.
Escapes are explicit: `# tidy: allow=<code> reason` on the line or the
enclosing def.

Not ported from jaxlint, on purpose for now: `retrace` (the port has no
jit; each kernel source is built once, keyed by its hash), and the
reference's `absint` pass over u128 limb arithmetic (the port's limb
arithmetic lives in the .cu kernel bodies, which cparse does not read).
"""

from __future__ import annotations

import ast
import pathlib
from typing import Dict, Iterable, List, Optional, Set, Tuple

from tigerbeetle_tpu_torch.tidy import annotations as ann_mod
from tigerbeetle_tpu_torch.tidy import manifest
from tigerbeetle_tpu_torch.tidy.findings import Finding

NONE, HOST, DEVICE = 0, 1, 2

# torch constructors: placed by their `device=` / `pin_memory=` keywords.
CTORS = frozenset((
    "empty", "zeros", "ones", "full", "arange", "tensor", "as_tensor",
    "empty_strided", "linspace", "eye",
))
# Tensor methods (and torch functions) whose result is a host value.
HOST_RESULTS = frozenset((
    "item", "tolist", "numpy", "dim", "size", "numel", "nelement",
    "data_ptr", "element_size", "is_contiguous", "stride", "get_device",
    "is_pinned", "storage_offset", "is_tensor",
))
UNTAINT_ATTRS = frozenset(("shape", "dtype", "device", "ndim", "is_cuda", "type"))
UNTAINT_CALLS = frozenset(("len", "isinstance", "range", "type", "getattr",
                           "hasattr", "id"))
# Applied to a DEVICE value, these return a host value: a sync.
MATERIALIZERS = frozenset(("bool", "int", "float"))
TORCH_MATERIALIZERS = frozenset(("equal", "allclose", "is_nonzero"))

FLOAT_DTYPES = frozenset(("float16", "float32", "float64", "bfloat16",
                          "half", "float", "double"))
FLOAT_METHODS = frozenset(("float", "double", "half", "bfloat16"))
REDUCERS = frozenset(("index_add_", "index_add", "scatter_add_", "scatter_add",
                      "scatter_reduce_", "scatter_reduce", "index_reduce_",
                      "index_reduce", "sum", "cumsum", "mean", "nansum"))

PASS_SYNC = "host-sync"
PASS_REDUCTION = "reduction"


def _tail(func) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _is_torch(node, torch_names: Set[str]) -> bool:
    """`node` is the torch module (by any import alias)."""
    return isinstance(node, ast.Name) and node.id in torch_names


def _kw(call: ast.Call, name: str):
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _is_cpu(node) -> bool:
    """The literal "cpu", or torch.device("cpu")."""
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return (isinstance(node, ast.Call) and _tail(node.func) == "device"
            and node.args and _is_cpu(node.args[0]))


def _true(node) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


class _Fn:
    """Taint of one function's locals (flow-insensitive fixpoint)."""

    def __init__(self, fn, torch_names: Set[str], entries) -> None:
        self.fn = fn
        self.torch = torch_names
        self.entries = entries
        self.names: Dict[str, int] = {}
        self.floaty: Set[str] = set()
        for _ in range(8):
            before = (dict(self.names), set(self.floaty))
            for node in _own_nodes(fn):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        self._bind(t, node.value)
                elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and node.value:
                    self._bind(node.target, node.value)
                elif isinstance(node, (ast.For, ast.comprehension)):
                    self._bind(node.target, node.iter)
                elif isinstance(node, ast.withitem) and node.optional_vars:
                    self._bind(node.optional_vars, node.context_expr)
            if (self.names, self.floaty) == before:
                break

    def _bind(self, target, value) -> None:
        t = self.taint(value)
        f = self.is_float(value)
        for name in _target_names(target):
            if t > self.names.get(name, NONE):
                self.names[name] = t
            if f:
                self.floaty.add(name)

    def taint(self, node) -> int:
        if node is None:
            return NONE
        if isinstance(node, ast.Name):
            return self.names.get(node.id, NONE)
        if isinstance(node, ast.Attribute):
            if node.attr in UNTAINT_ATTRS:
                return NONE
            return self.taint(node.value)
        if isinstance(node, ast.Subscript):
            return self.taint(node.value)
        if isinstance(node, ast.Starred):
            return self.taint(node.value)
        if isinstance(node, (ast.BinOp,)):
            return max(self.taint(node.left), self.taint(node.right))
        if isinstance(node, ast.UnaryOp):
            return self.taint(node.operand)
        if isinstance(node, ast.BoolOp):
            return max(self.taint(v) for v in node.values)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return NONE  # identity and membership: no tensor result
            return max([self.taint(node.left)] + [self.taint(c) for c in node.comparators])
        if isinstance(node, ast.IfExp):
            return max(self.taint(node.body), self.taint(node.orelse))
        if isinstance(node, (ast.Tuple, ast.List)):
            return max([self.taint(e) for e in node.elts], default=NONE)
        if isinstance(node, (ast.GeneratorExp, ast.ListComp)):
            return self.taint(node.elt)
        if isinstance(node, ast.Call):
            return self.call_taint(node)
        return NONE

    def call_taint(self, node: ast.Call) -> int:
        func = node.func
        tail = _tail(func)
        if tail in self.entries:
            return DEVICE
        if tail in UNTAINT_CALLS or tail in HOST_RESULTS or tail in MATERIALIZERS:
            return NONE
        args = list(node.args) + [k.value for k in node.keywords]
        if isinstance(func, ast.Attribute) and _is_torch(func.value, self.torch):
            if tail == "from_numpy":
                return HOST
            if tail in CTORS or tail.endswith("_like"):
                dev = _kw(node, "device")
                if _kw(node, "pin_memory") is not None or (dev is not None and _is_cpu(dev)):
                    return HOST
                if dev is not None:
                    return DEVICE
                if tail.endswith("_like") and node.args:
                    return self.taint(node.args[0])
                return HOST
            if tail in TORCH_MATERIALIZERS:
                return NONE
            return max([self.taint(a) for a in args], default=NONE)
        if isinstance(func, ast.Attribute):
            recv = self.taint(func.value)
            if tail == "cpu":
                return HOST
            if tail == "cuda":
                return DEVICE
            if tail == "to":
                if any(_is_cpu(a) for a in args):
                    return HOST
                if args and all(self._is_dtype(a) for a in node.args) and \
                        _kw(node, "device") is None:
                    return recv
                return DEVICE
            return recv
        if isinstance(func, ast.Name):
            # a local helper (a lambda or nested def): its arguments' taint
            return max([self.taint(a) for a in args], default=NONE)
        return NONE

    def _is_dtype(self, node) -> bool:
        return (isinstance(node, ast.Attribute) and _is_torch(node.value, self.torch)
                and node.attr not in ("device",))

    def is_float(self, node) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and sub.id in self.floaty:
                return True
            if (isinstance(sub, ast.Attribute) and sub.attr in FLOAT_DTYPES
                    and _is_torch(sub.value, self.torch)):
                return True
            if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in FLOAT_METHODS and not sub.args):
                return True
        return False


def _target_names(target) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for e in target.elts for n in _target_names(e)]
    if isinstance(target, ast.Starred):
        return _target_names(target.value)
    return []


def _own_nodes(fn) -> Iterable[ast.AST]:
    """Nodes of `fn`'s body, nested defs excluded (they are functions of
    their own)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            stack.append(child)


def _functions(tree) -> List[Tuple[str, ast.AST]]:
    out = []

    def walk(body, prefix):
        for n in body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((prefix + n.name, n))
                walk(n.body, prefix + n.name + ".")
            elif isinstance(n, ast.ClassDef):
                walk(n.body, prefix + n.name + ".")
    walk(tree.body, "")
    return out


def _torch_names(tree) -> Set[str]:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch":
                    names.add(a.asname or "torch")
    return names or {"torch"}


def _covered(qual: str, quals) -> bool:
    """`qual` is one of `quals` or nested in one."""
    return any(qual == q or qual.startswith(q + ".") for q in quals)


class _Lint:
    def __init__(self, rel, tree, anns, passes, entries) -> None:
        self.rel = rel
        self.tree = tree
        self.anns = anns
        self.passes = passes
        self.entries = entries
        self.torch = _torch_names(tree)
        self.findings: List[Finding] = []

    def flag(self, pass_name, code, line, scope, subject, message, def_line):
        if pass_name not in self.passes:
            return
        for ln in (line, def_line):
            a = ann_mod.lookup(self.anns, ln)
            if a is not None and (a.allows(code) or a.allows(pass_name)):
                return
        self.findings.append(Finding(pass_name, code, self.rel, line, scope,
                                     subject, message))

    def lint(self, qual: str, fn) -> None:
        t = _Fn(fn, self.torch, self.entries)
        d = fn.lineno

        def sync(node, subject, message, code="host-sync"):
            self.flag(PASS_SYNC, code, node.lineno, qual, subject, message, d)

        for node in _own_nodes(fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                if t.taint(node.test) == DEVICE:
                    sync(node.test, type(node).__name__.lower(),
                         "branch on a tensor on the card: waits for it",
                         code="device-branch")
            if not isinstance(node, ast.Call):
                continue
            func, tail = node.func, _tail(node.func)
            if isinstance(func, ast.Attribute):
                recv = t.taint(func.value)
                if tail == "synchronize":
                    sync(node, ast.unparse(func), "waits for the card outside "
                         "the dispatch/finish seam", code="unfenced-sync")
                elif tail in ("item", "cpu"):
                    sync(node, f".{tail}()", f".{tail}() copies back from the "
                         "card and waits for it")
                elif tail in ("tolist", "numpy") and recv == DEVICE:
                    sync(node, f".{tail}()", f".{tail}() of a tensor on the card")
                elif tail == "to" and any(_is_cpu(a) for a in list(node.args) + [
                        k.value for k in node.keywords]) and not _true(
                        _kw(node, "non_blocking")):
                    sync(node, '.to("cpu")', "a blocking copy back from the card")
                elif (tail == "copy_" and recv == HOST and node.args
                      and t.taint(node.args[0]) != HOST
                      and not _true(_kw(node, "non_blocking"))):
                    sync(node, ".copy_()", "a blocking copy into a host buffer")
                elif (tail in TORCH_MATERIALIZERS and _is_torch(func.value, self.torch)
                      and any(t.taint(a) == DEVICE for a in node.args)):
                    sync(node, f"torch.{tail}()", f"torch.{tail}() returns a host "
                         "bool: it waits for the card")
                if tail in REDUCERS and (t.is_float(func.value) or any(
                        t.is_float(a) for a in node.args)):
                    self.flag(PASS_REDUCTION, "unordered-reduce", node.lineno, qual,
                              tail, f"{tail} over float values: the accumulation "
                              "order on CUDA is not fixed", d)
                if tail in FLOAT_METHODS and not node.args:
                    self.flag(PASS_REDUCTION, "float-dtype", node.lineno, qual,
                              f".{tail}()", "a float value on the ledger's "
                              "integer path", d)
            elif (isinstance(func, ast.Name) and tail in MATERIALIZERS
                  and node.args and t.taint(node.args[0]) == DEVICE):
                sync(node, f"{tail}()", f"{tail}() of a tensor on the card")
        for node in _own_nodes(fn):
            if (isinstance(node, ast.Attribute) and node.attr in FLOAT_DTYPES
                    and _is_torch(node.value, self.torch)):
                self.flag(PASS_REDUCTION, "float-dtype", node.lineno, qual,
                          f"torch.{node.attr}", "a float dtype on the ledger's "
                          "integer path", d)


def analyze_file(path, root, passes=(PASS_SYNC, PASS_REDUCTION), seam=(),
                 host_only=(), entries=None) -> List[Finding]:
    """Findings of one module: every function is hot except the qualified
    names in `seam` and `host_only` (and the defs nested in them)."""
    path = pathlib.Path(path)
    root = pathlib.Path(root)
    source = path.read_text()
    rel = path.resolve().relative_to(root.resolve()).as_posix()
    tree = ast.parse(source)
    lint = _Lint(rel, tree, ann_mod.collect(source), set(passes),
                 manifest.KERNEL_ENTRIES if entries is None else entries)
    fns = _functions(tree)
    quals = {q for q, _ in fns}
    skip = set(seam) | set(host_only)
    for q in sorted(skip - quals):
        lint.flag(PASS_SYNC, "stale-seam", 1, "manifest", q,
                  f"{q} is named as a seam or host-only but {rel} has no such "
                  "function", 0)
    for qual, fn in fns:
        if not _covered(qual, skip):
            lint.lint(qual, fn)
    return lint.findings


def run_selected(root, passes) -> List[Finding]:
    root = pathlib.Path(root)
    findings: List[Finding] = []
    for rel in manifest.SYNCLINT_MODULES:
        path = root / rel
        if not path.exists():
            continue
        seam = {q for r, q in manifest.SYNCLINT_SEAM if r == rel}
        host_only = {q for r, q in manifest.SYNCLINT_HOST_ONLY if r == rel}
        findings.extend(analyze_file(path, root, passes, seam, host_only))
    return findings
