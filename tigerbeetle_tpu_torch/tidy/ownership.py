"""Thread-ownership / lockset static pass (Eraser-style, lexical).

For every pipeline-coupled class (manifest.OWNERSHIP_CLASSES, plus any
class carrying a `# tidy:` annotation) the pass:

  1. collects attribute declarations from annotations on `self.X = ...`
     lines (`owner=<roles>`, `guarded-by=<lock attr>`, `atomic`);
  2. resolves the thread role set of every method — `thread=` def
     annotations, `threading.Thread(target=self._x, name=...)`
     constructions (name mapped through manifest.THREAD_NAME_ROLES),
     manifest defaults, and a fixed-point propagation over the
     intra-class `self.m()` call graph (an unannotated helper inherits
     the union of its callers' roles);
  3. computes per-method attribute read/write sets with the lexical
     lockset held at each access — `with self.<lock>:` scopes plus
     `holds=<lock>` def annotations. A mutating method call on the
     attribute (`self._pending.append(...)`) counts as a write;
  4. flags:
       wrong-thread      access to an `owner=`-declared attribute from
                         a method whose role set is not covered;
       unlocked-access   access to a `guarded-by=`-declared attribute
                         outside its lock scope;
       undeclared-shared an undeclared attribute written outside
                         `__init__` and touched from more than one
                         role with an empty common lockset (the
                         classic Eraser condition).

Escapes are explicit, never silent: `# tidy: allow=<code> reason` on
the access or def line, `barrier=<name>` for accesses sequenced by a
declared barrier (manifest.BARRIERS), `atomic` for GIL-atomic handoff
structures, or a checked-in baseline entry. Module-level globals of
manifest.OWNERSHIP_MODULES get the same treatment with functions in
place of methods and bare-name locks in `with` scopes.

Limits (by design — this is a lexical pass, not an interprocedural
alias analysis): cross-class call edges are not traced, so a public
method's role set is a declaration; mutation through a non-listed
method name or through an alias (`p = self._pending; p.append(...)`)
is invisible. The runtime assertions (tidy/runtime.py) cover the
dynamic side of the same invariants.
"""

from __future__ import annotations

import ast
import pathlib
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple

from tigerbeetle_tpu_torch.tidy import annotations as ann_mod
from tigerbeetle_tpu_torch.tidy import manifest
from tigerbeetle_tpu_torch.tidy.findings import Finding

# Method names whose call mutates the receiver (collection handoff
# structures): self.X.append(...) is a WRITE to X for lockset purposes.
MUTATORS = frozenset((
    "append", "appendleft", "extend", "extendleft", "insert",
    "pop", "popleft", "popitem", "clear", "update", "add",
    "discard", "remove", "setdefault", "sort", "reverse", "move_to_end",
))


@dataclass
class Access:
    attr: str
    method: str
    roles: FrozenSet[str]
    locks: FrozenSet[str]
    kind: str  # "read" | "write"
    line: int


@dataclass
class Decl:
    kind: str  # "owner" | "guarded-by" | "atomic"
    value: FrozenSet[str]
    line: int


def run(root) -> List[Finding]:
    root = pathlib.Path(root)
    findings: List[Finding] = []
    pkg = root / manifest.PACKAGE
    for path in sorted(pkg.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        findings.extend(analyze_file(path, root))
    return findings


def analyze_file(path, root) -> List[Finding]:
    path = pathlib.Path(path)
    root = pathlib.Path(root)
    source = path.read_text()
    rel = path.resolve().relative_to(root.resolve()).as_posix()
    anns = ann_mod.collect(source)
    tree = ast.parse(source)
    findings = ann_mod.unknown_key_findings(rel, anns)
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            default = manifest.OWNERSHIP_CLASSES.get((rel, node.name))
            if default is None and not _class_annotated(node, anns):
                continue
            findings.extend(
                _ClassAnalysis(node, rel, anns, default or "loop").findings()
            )
    module_default = manifest.OWNERSHIP_MODULES.get(rel)
    if module_default is not None:
        findings.extend(_analyze_module(tree, rel, anns, module_default))
    return findings


def _class_annotated(node: ast.ClassDef, anns) -> bool:
    last = max((getattr(n, "end_lineno", n.lineno) for n in ast.walk(node)
                if hasattr(n, "lineno")), default=node.lineno)
    return any(
        line for line, a in anns.items()
        if node.lineno <= line <= last and (set(a.clauses) - {"allow"})
    )


def _allowed(anns, lines, code: str, pass_name: str = "ownership") -> bool:
    for line in lines:
        a = ann_mod.lookup(anns, line)
        if a is not None and (a.allows(code) or a.allows(pass_name)):
            return True
    return False


def _barriered(anns, line: int) -> bool:
    a = ann_mod.lookup(anns, line)
    return a is not None and bool(a.roles("barrier") & manifest.BARRIERS)


class _AccessCollector(ast.NodeVisitor):
    """Attribute accesses of one method body, with the lexical lockset.

    `owner_name` is "self" for methods; None for module-level functions
    (bare globals tracked through `declared` names instead)."""

    def __init__(self, owner_name: Optional[str], declared_globals=()) -> None:
        self.owner = owner_name
        self.declared_globals = frozenset(declared_globals)
        self.locks: List[str] = []
        self.out: List[Tuple[str, str, int, FrozenSet[str]]] = []

    # --- helpers ---------------------------------------------------------

    def _is_owner_attr(self, node) -> Optional[str]:
        if (
            self.owner is not None
            and isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == self.owner
        ):
            return node.attr
        return None

    def _is_tracked_global(self, node) -> Optional[str]:
        if (
            self.owner is None
            and isinstance(node, ast.Name)
            and node.id in self.declared_globals
        ):
            return node.id
        return None

    def _target(self, node) -> Optional[str]:
        return self._is_owner_attr(node) or self._is_tracked_global(node)

    def _record(self, name: str, kind: str, line: int) -> None:
        self.out.append((name, kind, line, frozenset(self.locks)))

    # --- lock scopes ------------------------------------------------------

    def _lock_name(self, expr) -> Optional[str]:
        name = self._target(expr)
        if name is not None:
            return name
        # Module functions lock bare names even when not declared data.
        if self.owner is None and isinstance(expr, ast.Name):
            return expr.id
        return None

    def visit_With(self, node) -> None:
        pushed = 0
        for item in node.items:
            lock = self._lock_name(item.context_expr)
            if lock is not None:
                self.locks.append(lock)
                pushed += 1
            self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        if pushed:
            del self.locks[-pushed:]

    visit_AsyncWith = visit_With

    # --- accesses ---------------------------------------------------------

    def visit_Attribute(self, node) -> None:
        name = self._target(node)
        if name is not None:
            kind = "read" if isinstance(node.ctx, ast.Load) else "write"
            self._record(name, kind, node.lineno)
        self.generic_visit(node)

    def visit_Name(self, node) -> None:
        name = self._is_tracked_global(node)
        if name is not None:
            kind = "read" if isinstance(node.ctx, ast.Load) else "write"
            self._record(name, kind, node.lineno)

    def visit_Call(self, node) -> None:
        # self.X.mutator(...)  /  GLOBAL.mutator(...)  → write to X.
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in MUTATORS:
            name = self._target(f.value)
            if name is not None:
                self._record(name, "write", node.lineno)
        self.generic_visit(node)

    def visit_Subscript(self, node) -> None:
        # self.X[k] = v  /  del self.X[k]  → write to X.
        if not isinstance(node.ctx, ast.Load):
            name = self._target(node.value)
            if name is not None:
                self._record(name, "write", node.lineno)
        self.generic_visit(node)

    # Nested defs run on whoever calls them (callbacks): skip their
    # bodies — their accesses cannot be attributed to this method's role.
    def visit_FunctionDef(self, node) -> None:
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node) -> None:
        pass


class _ClassAnalysis:
    def __init__(self, node: ast.ClassDef, rel: str, anns, default_role: str) -> None:
        self.node = node
        self.rel = rel
        self.anns = anns
        self.default_role = default_role
        self.methods: Dict[str, ast.FunctionDef] = {
            n.name: n for n in node.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }

    # --- declarations -----------------------------------------------------

    def _decls(self) -> Dict[str, Decl]:
        out: Dict[str, Decl] = {}
        for fn in self.methods.values():
            for sub in ast.walk(fn):
                if not isinstance(sub, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                    continue
                a = ann_mod.lookup(self.anns, sub.lineno)
                if a is None:
                    continue
                targets = sub.targets if isinstance(sub, ast.Assign) else [sub.target]
                for t in targets:
                    if not (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        continue
                    if "owner" in a:
                        out[t.attr] = Decl("owner", a.roles("owner"), sub.lineno)
                    elif "guarded-by" in a:
                        out[t.attr] = Decl(
                            "guarded-by", a.roles("guarded-by"), sub.lineno
                        )
                    elif "atomic" in a:
                        out[t.attr] = Decl("atomic", frozenset(), sub.lineno)
        return out

    # --- method roles -----------------------------------------------------

    def _roles(self) -> Dict[str, FrozenSet[str]]:
        roles: Dict[str, FrozenSet[str]] = {}
        explicit: set = set()
        for name, fn in self.methods.items():
            a = ann_mod.lookup(self.anns, fn.lineno)
            if a is not None and "thread" in a:
                roles[name] = a.roles("thread")
                explicit.add(name)
        # threading.Thread(target=self._x, name="...") constructions.
        for fn in self.methods.values():
            for sub in ast.walk(fn):
                if not isinstance(sub, ast.Call):
                    continue
                callee = sub.func
                is_thread = (
                    isinstance(callee, ast.Attribute) and callee.attr == "Thread"
                ) or (isinstance(callee, ast.Name) and callee.id == "Thread")
                if not is_thread:
                    continue
                target = thread_name = None
                for kw in sub.keywords:
                    if kw.arg == "target" and isinstance(kw.value, ast.Attribute):
                        if (
                            isinstance(kw.value.value, ast.Name)
                            and kw.value.value.id == "self"
                        ):
                            target = kw.value.attr
                    if kw.arg == "name" and isinstance(kw.value, ast.Constant):
                        thread_name = kw.value.value
                role = manifest.THREAD_NAME_ROLES.get(thread_name)
                if target is not None and role is not None and target not in explicit:
                    roles[target] = frozenset((role,))
                    explicit.add(target)
        # Intra-class call graph: unannotated methods inherit the union
        # of their callers' roles (fixed point).
        callees: Dict[str, set] = {}
        for name, fn in self.methods.items():
            cs = set()
            for sub in ast.walk(fn):
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and isinstance(sub.func.value, ast.Name)
                    and sub.func.value.id == "self"
                    and sub.func.attr in self.methods
                ):
                    cs.add(sub.func.attr)
            callees[name] = cs
        changed = True
        while changed:
            changed = False
            for caller, cs in callees.items():
                cr = roles.get(caller)
                if not cr:
                    continue
                for c in cs:
                    if c in explicit:
                        continue
                    merged = roles.get(c, frozenset()) | cr
                    if merged != roles.get(c):
                        roles[c] = merged
                        changed = True
        default = frozenset(self.default_role.split("|"))
        for name in self.methods:
            roles.setdefault(name, default)
        return roles

    # --- accesses ---------------------------------------------------------

    def _exempt(self, name: str, fn) -> bool:
        if name == "__init__":
            return True
        a = ann_mod.lookup(self.anns, fn.lineno)
        return a is not None and "init" in a

    def _accesses(self, roles) -> Dict[str, List[Access]]:
        out: Dict[str, List[Access]] = {}
        for name, fn in self.methods.items():
            if self._exempt(name, fn):
                continue
            col = _AccessCollector("self")
            a = ann_mod.lookup(self.anns, fn.lineno)
            if a is not None and "holds" in a:
                col.locks.extend(a.roles("holds"))
            for stmt in fn.body:
                col.visit(stmt)
            for attr, kind, line, locks in col.out:
                out.setdefault(attr, []).append(
                    Access(attr, name, roles[name], locks, kind, line)
                )
        return out

    # --- rules ------------------------------------------------------------

    def findings(self) -> List[Finding]:
        decls = self._decls()
        roles = self._roles()
        accesses = self._accesses(roles)
        return _evaluate(
            decls, accesses, self.rel, self.node.name, self.anns,
            {n: self.methods[n].lineno for n in self.methods},
        )


def _evaluate(decls, accesses, rel, scope_prefix, anns, def_lines) -> List[Finding]:
    findings: List[Finding] = []

    def scope(method: str) -> str:
        return f"{scope_prefix}.{method}"

    for attr in sorted(accesses):
        accs = accesses[attr]
        decl = decls.get(attr)
        if decl is not None and decl.kind == "atomic":
            continue
        if decl is not None and decl.kind == "guarded-by":
            # A |-joined declaration means "any of these locks protects
            # the attribute": the access must hold at least one (checked
            # against the whole set — deterministic regardless of
            # frozenset iteration order).
            locks = decl.value
            shown = "|".join(sorted(locks))
            for a in accs:
                if a.locks & locks:
                    continue
                lines = (a.line, def_lines.get(a.method, -1))
                if _allowed(anns, lines, "unlocked-access") or _barriered(anns, a.line):
                    continue
                findings.append(Finding(
                    "ownership", "unlocked-access", rel, a.line,
                    scope(a.method), attr,
                    f"{a.kind} of {attr!r} (guarded-by={shown}) outside "
                    f"`with {shown}:` scope",
                ))
            continue
        if decl is not None and decl.kind == "owner":
            allowed_roles = decl.value
            for a in accs:
                if a.roles <= allowed_roles:
                    continue
                lines = (a.line, def_lines.get(a.method, -1))
                if _allowed(anns, lines, "wrong-thread") or _barriered(anns, a.line):
                    continue
                findings.append(Finding(
                    "ownership", "wrong-thread", rel, a.line,
                    scope(a.method), attr,
                    f"{a.kind} of {attr!r} (owner={'|'.join(sorted(allowed_roles))})"
                    f" from {a.method} which runs on "
                    f"{'|'.join(sorted(a.roles))}",
                ))
            continue
        # Undeclared: the Eraser condition — written outside __init__,
        # touched from more than one role, no common lock.
        live = [
            a for a in accs
            if not _allowed(
                anns, (a.line, def_lines.get(a.method, -1)), "undeclared-shared"
            ) and not _barriered(anns, a.line)
        ]
        writes = [a for a in live if a.kind == "write"]
        if not writes:
            continue
        roles_union = frozenset().union(*(a.roles for a in live))
        if "any" not in roles_union and len(roles_union) <= 1:
            continue
        common = frozenset.intersection(*(a.locks for a in live))
        if common:
            continue
        sites = sorted({(a.method, a.kind) for a in live})
        findings.append(Finding(
            "ownership", "undeclared-shared", rel, writes[0].line,
            f"{scope_prefix}", attr,
            f"attribute {attr!r} is written outside __init__ and touched "
            f"from roles {{{', '.join(sorted(roles_union))}}} with no "
            f"common lock and no tidy declaration (sites: "
            f"{', '.join(f'{m}/{k}' for m, k in sites)})",
        ))
    return findings


def _analyze_module(tree, rel, anns, default_role: str) -> List[Finding]:
    """Module-global variant: top-level functions are the methods, bare
    names the attributes, `with <Name>:` the lock scopes."""
    findings: List[Finding] = []
    decls: Dict[str, Decl] = {}
    mutable_globals: Dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names = [t.id for t in targets if isinstance(t, ast.Name)]
            if not names:
                continue
            a = ann_mod.lookup(anns, node.lineno)
            for name in names:
                if a is not None and "owner" in a:
                    decls[name] = Decl("owner", a.roles("owner"), node.lineno)
                elif a is not None and "guarded-by" in a:
                    decls[name] = Decl("guarded-by", a.roles("guarded-by"), node.lineno)
                elif a is not None and "atomic" in a:
                    decls[name] = Decl("atomic", frozenset(), node.lineno)
                elif _is_mutable_literal(node.value):
                    mutable_globals[name] = node.lineno
    for name, line in sorted(mutable_globals.items()):
        if name not in decls and not _allowed(anns, (line,), "undeclared-global"):
            findings.append(Finding(
                "ownership", "undeclared-global", rel, line, "module", name,
                f"mutable module global {name!r} has no tidy declaration "
                f"(owner=/guarded-by=/atomic) — cross-thread recording "
                f"modules must declare every shared container",
            ))
    funcs = {
        n.name: n for n in tree.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    accesses: Dict[str, List[Access]] = {}
    def_lines = {n: f.lineno for n, f in funcs.items()}
    tracked = frozenset(decls)
    for name, fn in funcs.items():
        col = _AccessCollector(None, declared_globals=tracked)
        a = ann_mod.lookup(anns, fn.lineno)
        if a is not None and "holds" in a:
            col.locks.extend(a.roles("holds"))
        for stmt in fn.body:
            col.visit(stmt)
        role = frozenset((default_role,))
        for attr, kind, line, locks in col.out:
            accesses.setdefault(attr, []).append(
                Access(attr, name, role, locks, kind, line)
            )
    findings.extend(_evaluate(decls, accesses, rel, "module", anns, def_lines))
    return findings


def _is_mutable_literal(value) -> bool:
    if value is None:
        return False
    if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.ListComp, ast.DictComp)):
        return True
    if isinstance(value, ast.Call):
        f = value.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None
        )
        return name in ("dict", "list", "set", "deque", "OrderedDict", "defaultdict")
    return False
