"""VSR protocol lints: the consensus-critical layer, machine-checked.

The reference encodes its consensus safety in comptime asserts and the
VOPR; the protocol layer here (vsr/replica.py and friends) is the one
place where a subtle bug silently loses committed state, yet it had no
static story beyond seeded simulation. Three rules (pass `vsrlint`)
plus one exhaustive-evaluation pass (`quorum`):

  - `unhandled-command` — handler exhaustiveness. Every `Command` enum
    member must reach an entry in `Replica.on_message`'s dispatch table
    or carry an explicit exempt-with-reason in
    manifest.VSRLINT_COMMAND_EXEMPT (where the command IS handled: the
    bus ingress, the client library). A new wire command with no
    backup-path handler is a finding; so is a rotted exemption (the
    command grew a handler, or left the enum).
  - `wire-taint` — fields read off an inbound message header
    (view/op/commit/checksum/client ids — manifest.VSRLINT_WIRE_FIELDS)
    are attacker-controlled until they pass a validation guard: any use
    in an `if`/`assert`/`while` test (view comparison, bounds check,
    MAC verify) inside the handler, or a clamped adoption through
    `max()/min()` against existing state. Assigning a still-tainted
    value into protocol state (manifest.VSRLINT_STATE_FIELDS) is a
    finding. Built on a two-point taint lattice like the sync lint's
    device/host passes (CLEAN < WIRE), specialized to per-handler
    linear flow.
  - `non-monotonic` — assignments to the monotone protocol fields
    (view/log_view/op/commit_min/… — manifest.VSRLINT_MONOTONIC_FIELDS)
    must be PROVEN non-decreasing: `x = max(x, …)`, `x += <nonneg>`,
    `x = x + <nonneg>`, an enclosing or dominating guard comparing the
    assigned value against the field, or an explicit
    `# tidy: monotonic=<field> — reason` annotation (the sanctioned
    bump-helper discipline, `range=`'s sibling). Constructors and
    `format` establish state and are exempt; recovery paths annotate.
  - `quorum-arith` (pass `quorum`) — the replica-count→quorum tables
    are extracted from source (no runtime import) and exhaustively
    evaluated for every cluster size 1..6 × standby count 0..6,
    proving prepare-quorum ∩ view-change-quorum nonempty (the VSR
    safety intersection), 1 ≤ q ≤ replica_count, and that standbys
    never enter the formulas — reference-comptime-assert style.
    `prove_quorums` returns the checked-assertion count so the test
    suite can pin the proof non-vacuous.

Scope: manifest.VSRLINT_MODULES. Suppression: inline
`# tidy: allow=<code> — reason` or the shared baseline, same as every
other pass.
"""

from __future__ import annotations

import ast
import pathlib
from typing import Dict, List, Optional, Set, Tuple

from tigerbeetle_tpu_torch.tidy import annotations as ann_mod
from tigerbeetle_tpu_torch.tidy import manifest
from tigerbeetle_tpu_torch.tidy.findings import Finding

PASS = "vsrlint"

CLEAN, WIRE = 0, 1  # the two-point lattice


def _rel(path: pathlib.Path, root: pathlib.Path) -> str:
    return path.resolve().relative_to(root.resolve()).as_posix()


def _allowed(anns, lines, code: str) -> bool:
    for ln in lines:
        a = ann_mod.lookup(anns, ln)
        if a is not None and (a.allows(code) or a.allows(PASS)):
            return True
    return False


# --- handler exhaustiveness ----------------------------------------------


def _command_members(tree: ast.Module) -> Dict[str, int]:
    """NAME -> value assignments of the Command class body."""
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "Command":
            out: Dict[str, int] = {}
            for stmt in node.body:
                if (
                    isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and isinstance(stmt.value, ast.Constant)
                    and isinstance(stmt.value.value, int)
                ):
                    out[stmt.targets[0].id] = stmt.value.value
            return out
    return {}


def _dispatched_commands(tree: ast.Module, func_name: str) -> Tuple[Set[str], int]:
    """Command member names keyed in the dispatch dict literal inside
    `func_name` (searched anywhere in the module), plus its line."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == func_name:
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Dict):
                    continue
                names: Set[str] = set()
                for k in sub.keys:
                    if (
                        isinstance(k, ast.Attribute)
                        and isinstance(k.value, ast.Name)
                        and k.value.id == "Command"
                    ):
                        names.add(k.attr)
                if names:
                    return names, sub.lineno
            return set(), node.lineno
    return set(), 1


def check_exhaustiveness(
    header_path: pathlib.Path, dispatch_path: pathlib.Path,
    root: pathlib.Path,
) -> Tuple[List[Finding], int]:
    """(findings, commands checked). Checked count covers every enum
    member plus every exemption entry — the coverage pin."""
    findings: List[Finding] = []
    members = _command_members(ast.parse(header_path.read_text()))
    dispatch_rel = _rel(dispatch_path, root)
    dispatched, dict_line = _dispatched_commands(
        ast.parse(dispatch_path.read_text()), manifest.VSRLINT_DISPATCH[1]
    )
    exempt = manifest.VSRLINT_COMMAND_EXEMPT
    checked = 0
    if not members:
        findings.append(Finding(
            PASS, "unhandled-command", _rel(header_path, root), 1,
            "Command", "Command",
            "could not locate the Command enum class body "
            "(handler-exhaustiveness has nothing to prove against)",
        ))
        return findings, checked
    if not dispatched:
        findings.append(Finding(
            PASS, "unhandled-command", dispatch_rel, dict_line,
            manifest.VSRLINT_DISPATCH[1], "dispatch",
            "could not locate the Command dispatch dict literal",
        ))
        return findings, checked
    for name in sorted(members):
        checked += 1
        if name in dispatched and name in exempt:
            findings.append(Finding(
                PASS, "unhandled-command", dispatch_rel, dict_line,
                manifest.VSRLINT_DISPATCH[1], name,
                f"Command.{name} is BOTH dispatched and exempted in "
                "manifest.VSRLINT_COMMAND_EXEMPT — drop the stale "
                "exemption",
            ))
        elif name not in dispatched and name not in exempt:
            findings.append(Finding(
                PASS, "unhandled-command", dispatch_rel, dict_line,
                manifest.VSRLINT_DISPATCH[1], name,
                f"Command.{name} reaches no dispatch handler and carries "
                "no manifest exemption — a wire command the replica "
                "silently drops (add the handler, or the exempt-with-"
                "reason naming where it IS handled)",
            ))
    for name in sorted(exempt):
        checked += 1
        if name not in members:
            findings.append(Finding(
                PASS, "unhandled-command", dispatch_rel, dict_line,
                manifest.VSRLINT_DISPATCH[1], name,
                f"manifest exemption for Command.{name} names no existing "
                "enum member — stale entry",
            ))
    return findings, checked


# --- shared AST helpers ---------------------------------------------------


def _attr_chain(node) -> Optional[str]:
    """Dotted name of an attribute chain rooted at a Name, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _names_in(node) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


# --- wire-taint -----------------------------------------------------------


class _TaintWalk:
    """Per-handler linear taint flow: header-subscript reads taint names
    (WIRE); any use in a branch/assert test validates them (CLEAN); an
    assignment of a still-WIRE value into protocol state is a finding."""

    def __init__(self, owner: "_ModuleLint", fn, scope: str) -> None:
        self.o = owner
        self.fn = fn
        self.scope = scope
        # Names aliasing an inbound header: the msg parameter's `.header`
        # plus local aliases (`h = msg.header`).
        self.header_names: Set[str] = set()
        self.msg_names: Set[str] = set()
        self.taint: Dict[str, int] = {}
        self.findings: List[Finding] = []
        self.checked = 0  # taint-relevant assignments examined

    def run(self) -> None:
        args = self.fn.args
        params = [p.arg for p in (
            list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
        )]
        for p in params:
            if p in ("msg", "message", "m") or p.endswith("_msg"):
                self.msg_names.add(p)
        if not self.msg_names:
            return
        self._block(self.fn.body)

    # -- statement walk --

    def _block(self, body) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, stmt) -> None:
        if isinstance(stmt, ast.Assign):
            self._assign(stmt.targets, stmt.value, stmt)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._assign([stmt.target], stmt.value, stmt)
        elif isinstance(stmt, ast.AugAssign):
            self._check_sink(stmt.target, stmt.value, stmt)
        elif isinstance(stmt, ast.If):
            self._validate_test(stmt.test)
            self._block(stmt.body)
            self._block(stmt.orelse)
        elif isinstance(stmt, ast.While):
            self._validate_test(stmt.test)
            self._block(stmt.body)
            self._block(stmt.orelse)
        elif isinstance(stmt, ast.Assert):
            self._validate_test(stmt.test)
        elif isinstance(stmt, ast.For):
            self._block(stmt.body)
            self._block(stmt.orelse)
        elif isinstance(stmt, ast.Try):
            self._block(stmt.body)
            for h in stmt.handlers:
                self._block(h.body)
            self._block(stmt.orelse)
            self._block(stmt.finalbody)
        elif isinstance(stmt, ast.With):
            self._block(stmt.body)
        elif isinstance(stmt, ast.Expr):
            pass  # calls don't move taint into checked state fields
        # Return / nested defs / imports: no taint effect

    def _validate_test(self, test) -> None:
        """Every name mentioned in a branch test counts as validated
        from here on — the guard IS the comparison the rule demands."""
        for name in _names_in(test):
            if self.taint.get(name) == WIRE:
                self.taint[name] = CLEAN

    def _wire_read(self, node) -> bool:
        """Is this expression a subscript read of an inbound header
        field (`h["view"]`, `msg.header["op"]`)?"""
        if not isinstance(node, ast.Subscript):
            return False
        key = node.slice
        if not (isinstance(key, ast.Constant) and isinstance(key.value, str)):
            return False
        if key.value not in manifest.VSRLINT_WIRE_FIELDS:
            return False
        base = node.value
        if isinstance(base, ast.Name) and base.id in self.header_names:
            return True
        if (
            isinstance(base, ast.Attribute) and base.attr == "header"
            and isinstance(base.value, ast.Name)
            and base.value.id in self.msg_names
        ):
            return True
        return False

    def _expr_taint(self, node) -> int:
        """WIRE if the expression reads a header field or mentions a
        WIRE name; clamped max/min against self-state is CLEAN."""
        if isinstance(node, ast.Call):
            tail = node.func.id if isinstance(node.func, ast.Name) else None
            if tail in ("max", "min"):
                # Clamped adoption: max(self.x, wire) / min(bound, wire)
                # bounds the wire value by existing state — the guard in
                # value form.
                if any(
                    isinstance(a, ast.Attribute) or (
                        isinstance(a, ast.Call)
                        and self._expr_taint(a) == CLEAN
                    )
                    for a in node.args
                ):
                    return CLEAN
        for sub in ast.walk(node):
            if self._wire_read(sub):
                return WIRE
            if isinstance(sub, ast.Name) and self.taint.get(sub.id) == WIRE:
                return WIRE
        return CLEAN

    def _assign(self, targets, value, stmt) -> None:
        # Alias tracking: h = msg.header
        if (
            isinstance(value, ast.Attribute) and value.attr == "header"
            and isinstance(value.value, ast.Name)
            and value.value.id in self.msg_names
        ):
            for t in targets:
                if isinstance(t, ast.Name):
                    self.header_names.add(t.id)
            return
        t_val = self._expr_taint(value)
        for t in targets:
            if isinstance(t, ast.Name):
                self.taint[t.id] = t_val
            elif isinstance(t, (ast.Tuple, ast.List)):
                for e in t.elts:
                    if isinstance(e, ast.Name):
                        self.taint[e.id] = t_val
            else:
                self._check_sink(t, value, stmt, precomputed=t_val)

    def _check_sink(self, target, value, stmt, precomputed=None) -> None:
        chain = _attr_chain(target)
        if chain is None or not chain.startswith("self."):
            return
        field = chain.rsplit(".", 1)[-1]
        if field not in manifest.VSRLINT_STATE_FIELDS:
            return
        self.checked += 1
        t_val = precomputed if precomputed is not None \
            else self._expr_taint(value)
        if t_val != WIRE:
            return
        if _allowed(self.o.anns, (stmt.lineno, self.fn.lineno), "wire-taint"):
            return
        self.findings.append(Finding(
            PASS, "wire-taint", self.o.rel, stmt.lineno, self.scope, field,
            f"unvalidated wire value assigned into protocol state "
            f"`{chain}` — the inbound header field must pass a guard "
            "(view comparison / bounds check / clamped max()) before "
            "any write to replica state",
        ))


# --- monotonicity ---------------------------------------------------------


class _MonotonicWalk:
    """Prove every assignment to a monotone field non-decreasing, or
    demand the `monotonic=` annotation."""

    def __init__(self, owner: "_ModuleLint", fn, scope: str) -> None:
        self.o = owner
        self.fn = fn
        self.scope = scope
        self.findings: List[Finding] = []
        self.checked = 0
        # Guard context: names compared against a monotone field in an
        # enclosing/dominating test, per field.
        self._guarded: Dict[str, Set[str]] = {}
        fn_ann = ann_mod.lookup(owner.anns, fn.lineno)
        self._fn_monotonic = (
            fn_ann.roles("monotonic") if fn_ann is not None
            and "monotonic" in fn_ann else frozenset()
        )

    def run(self) -> None:
        if self.fn.name in manifest.VSRLINT_MONOTONIC_INIT_FUNCS:
            return
        self._block(self.fn.body)

    def _block(self, body) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, stmt) -> None:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                self._check(t, stmt.value, stmt, aug=None)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._check(stmt.target, stmt.value, stmt, aug=None)
        elif isinstance(stmt, ast.AugAssign):
            self._check(stmt.target, stmt.value, stmt, aug=stmt.op)
        elif isinstance(stmt, ast.If):
            self._absorb_guard(stmt.test)
            self._block(stmt.body)
            self._block(stmt.orelse)
        elif isinstance(stmt, ast.While):
            self._absorb_guard(stmt.test)
            self._block(stmt.body)
        elif isinstance(stmt, ast.Assert):
            self._absorb_guard(stmt.test)
        elif isinstance(stmt, (ast.For,)):
            self._block(stmt.body)
            self._block(stmt.orelse)
        elif isinstance(stmt, ast.Try):
            self._block(stmt.body)
            for h in stmt.handlers:
                self._block(h.body)
            self._block(stmt.orelse)
            self._block(stmt.finalbody)
        elif isinstance(stmt, ast.With):
            self._block(stmt.body)

    def _absorb_guard(self, test) -> None:
        """A comparison mentioning a monotone field anywhere in a test
        registers every co-mentioned name as guard-compared for that
        field (dominating-guard recognition, linear approximation)."""
        for cmp_node in ast.walk(test):
            if not isinstance(cmp_node, ast.Compare):
                continue
            fields: Set[str] = set()
            names: Set[str] = set()
            for side in [cmp_node.left] + list(cmp_node.comparators):
                # Walk the whole side: `x <= max(self.f, ...)` guards f
                # just as well as a bare `x <= self.f` does.
                for sub in ast.walk(side):
                    chain = _attr_chain(sub)
                    if chain is not None and chain.startswith("self.") and \
                            chain.rsplit(".", 1)[-1] in \
                            manifest.VSRLINT_MONOTONIC_FIELDS:
                        fields.add(chain.rsplit(".", 1)[-1])
                names |= _names_in(side)
            for f in fields:
                self._guarded.setdefault(f, set()).update(names)

    @staticmethod
    def _nonneg(node) -> bool:
        if isinstance(node, ast.Constant) and isinstance(node.value, int) \
                and not isinstance(node.value, bool):
            return node.value >= 0
        if isinstance(node, ast.Call):
            tail = node.func.id if isinstance(node.func, ast.Name) else (
                node.func.attr if isinstance(node.func, ast.Attribute)
                else None
            )
            return tail == "len"
        return False

    def _check(self, target, value, stmt, aug) -> None:
        chain = _attr_chain(target)
        if chain is None or not chain.startswith("self."):
            return
        field = chain.rsplit(".", 1)[-1]
        if field not in manifest.VSRLINT_MONOTONIC_FIELDS:
            return
        self.checked += 1
        if self._proven(chain, field, value, aug):
            return
        if field in self._fn_monotonic:
            return  # blessed bump helper (`monotonic=` on the def)
        line_ann = ann_mod.lookup(self.o.anns, stmt.lineno)
        if line_ann is not None and field in line_ann.roles("monotonic"):
            return
        if _allowed(self.o.anns, (stmt.lineno, self.fn.lineno),
                    "non-monotonic"):
            return
        self.findings.append(Finding(
            PASS, "non-monotonic", self.o.rel, stmt.lineno, self.scope,
            field,
            f"assignment to monotone protocol field `{chain}` is not "
            "provably non-decreasing (no max()/increment form, no "
            "dominating guard against the field) — route it through a "
            "sanctioned bump or annotate `# tidy: monotonic="
            f"{field} — reason`",
        ))

    def _proven(self, chain: str, field: str, value, aug) -> bool:
        if aug is not None:
            # x += e with e provably >= 0
            return isinstance(aug, ast.Add) and self._nonneg(value)
        # x = max(x, ...) — any arg textually equal to the target chain
        if isinstance(value, ast.Call):
            tail = value.func.id if isinstance(value.func, ast.Name) else None
            if tail == "max":
                for a in value.args:
                    if _attr_chain(a) == chain:
                        return True
        # x = x + <nonneg> (either side)
        if isinstance(value, ast.BinOp) and isinstance(value.op, ast.Add):
            left, right = value.left, value.right
            if _attr_chain(left) == chain and self._nonneg(right):
                return True
            if _attr_chain(right) == chain and self._nonneg(left):
                return True
        # x = x (self-assignment, vacuously monotone)
        if _attr_chain(value) == chain:
            return True
        # Guard-dominated adoption: every name in the RHS was compared
        # against this field in a dominating/enclosing test.
        rhs_names = _names_in(value)
        if rhs_names and rhs_names <= self._guarded.get(field, set()):
            return True
        return False


# --- one module's analysis ----------------------------------------------


class _ModuleLint:
    def __init__(self, path: pathlib.Path, root: pathlib.Path) -> None:
        source = path.read_text()
        self.rel = _rel(path, root)
        self.anns = ann_mod.collect(source)
        self.tree = ast.parse(source)
        self.findings: List[Finding] = []
        self.checked_taint = 0
        self.checked_monotonic = 0

    def run(self) -> "_ModuleLint":
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self._fn(item, f"{node.name}.{item.name}")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._fn(node, node.name)
        return self

    def _fn(self, fn, scope: str) -> None:
        tw = _TaintWalk(self, fn, scope)
        tw.run()
        self.findings.extend(tw.findings)
        self.checked_taint += tw.checked
        mw = _MonotonicWalk(self, fn, scope)
        mw.run()
        self.findings.extend(mw.findings)
        self.checked_monotonic += mw.checked


def analyze_file(path, root) -> List[Finding]:
    """Taint + monotonicity over one file (the fixture-test entry)."""
    return _ModuleLint(pathlib.Path(path), pathlib.Path(root)).run().findings


def analyze_file_counts(path, root) -> Tuple[List[Finding], int, int]:
    """(findings, taint-checked sinks, monotonic-checked assignments) —
    the coverage-pin entry."""
    m = _ModuleLint(pathlib.Path(path), pathlib.Path(root)).run()
    return m.findings, m.checked_taint, m.checked_monotonic


def run(root) -> List[Finding]:
    """The `vsrlint` pass: exhaustiveness + wire-taint + monotonicity
    over manifest.VSRLINT_MODULES."""
    root = pathlib.Path(root)
    findings: List[Finding] = []
    header = root / manifest.VSRLINT_COMMAND_MODULE
    dispatch = root / manifest.VSRLINT_DISPATCH[0]
    if header.exists() and dispatch.exists():
        findings.extend(check_exhaustiveness(header, dispatch, root)[0])
    for rel in manifest.VSRLINT_MODULES:
        path = root / rel
        if path.exists():
            findings.extend(analyze_file(path, root))
    findings.sort(key=lambda f: (f.file, f.line, f.code))
    return findings


# --- quorum arithmetic (pass `quorum`) -----------------------------------


def _extract_quorum_tables(tree: ast.Module) -> Dict[str, Dict[int, int]]:
    """{property name: {replica_count: quorum}} from the dict-literal
    subscript form `{1: 1, ...}[self.replica_count]`, plus which
    attribute the table is keyed by (recorded as `__key__` per table
    via a parallel dict)."""
    out: Dict[str, Dict[int, int]] = {}
    keys: Dict[str, str] = {}
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name not in ("quorum_replication", "quorum_view_change"):
            continue
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Subscript):
                continue
            if not isinstance(sub.value, ast.Dict):
                continue
            table: Dict[int, int] = {}
            ok = True
            for k, v in zip(sub.value.keys, sub.value.values):
                if isinstance(k, ast.Constant) and isinstance(v, ast.Constant) \
                        and isinstance(k.value, int) \
                        and isinstance(v.value, int):
                    table[k.value] = v.value
                else:
                    ok = False
            if ok and table:
                out[node.name] = table
                keys[node.name] = _attr_chain(sub.slice) or "?"
    out["__keys__"] = keys  # type: ignore[assignment]
    return out


def prove_quorums(path, root) -> Tuple[List[Finding], int]:
    """Exhaustively evaluate the quorum tables for every cluster size ×
    standby count; returns (findings, checked-assertion count)."""
    path = pathlib.Path(path)
    root = pathlib.Path(root)
    rel = _rel(path, root)
    tree = ast.parse(path.read_text())
    tables = _extract_quorum_tables(tree)
    keys: Dict[str, str] = tables.pop("__keys__", {})  # type: ignore
    findings: List[Finding] = []
    checked = 0
    missing = [n for n in ("quorum_replication", "quorum_view_change")
               if n not in tables]
    if missing:
        for name in missing:
            findings.append(Finding(
                "quorum", "quorum-arith", rel, 1, "Replica", name,
                f"could not extract the {name} table as a dict literal — "
                "the exhaustive proof has nothing to evaluate",
            ))
        return findings, checked
    q_r, q_vc = tables["quorum_replication"], tables["quorum_view_change"]
    lo, hi = manifest.VSRLINT_QUORUM_REPLICA_RANGE
    s_lo, s_hi = manifest.VSRLINT_QUORUM_STANDBY_RANGE

    def flag(subject: str, message: str) -> None:
        findings.append(Finding(
            "quorum", "quorum-arith", rel, 1, "Replica", subject, message,
        ))

    # Standby independence: the table subscript must be keyed by
    # replica_count, never by a standby-inclusive total.
    for name, key in keys.items():
        checked += 1
        if "standby" in key or key.rsplit(".", 1)[-1] != "replica_count":
            flag(name, f"{name} is keyed by `{key}` — quorums must be a "
                 "function of replica_count alone (standbys never vote)")
    for r in range(lo, hi + 1):
        if r not in q_r or r not in q_vc:
            flag(f"R={r}", f"no quorum table entry for replica_count={r}")
            continue
        qr, qv = q_r[r], q_vc[r]
        for standby in range(s_lo, s_hi + 1):
            # Quorums are drawn from the ACTIVE set only; evaluating the
            # same assertions at every standby count proves the bound
            # does not drift as standbys join (they are not in r).
            checked += 1
            if not (1 <= qr <= r):
                flag(f"R={r}", f"replication quorum {qr} outside 1..{r} "
                     f"(standby_count={standby})")
            checked += 1
            if not (1 <= qv <= r):
                flag(f"R={r}", f"view-change quorum {qv} outside 1..{r} "
                     f"(standby_count={standby})")
            # THE safety intersection: any prepare quorum and any
            # view-change quorum must share a replica, or a view change
            # can elect a log missing a committed op.
            checked += 1
            if qr + qv <= r:
                flag(f"R={r}",
                     f"prepare quorum ({qr}) ∩ view-change quorum ({qv}) "
                     f"may be EMPTY at replica_count={r} "
                     f"(standby_count={standby}): {qr}+{qv} <= {r}")
        # Fault-tolerance bound (reference vsr.zig quorums): the cluster
        # must stay available losing f = r - max(qr, qv) replicas, and
        # f must be >= 0 (quorums can't exceed the cluster).
        checked += 1
        if max(qr, qv) > r:
            flag(f"R={r}", f"quorum exceeds cluster size at R={r}")
        # Monotonicity across sizes: a bigger cluster never has a
        # smaller view-change quorum (the table is hand-written; a
        # transposed digit here is a silent split-brain).
        if r > lo and (r - 1) in q_vc:
            checked += 1
            if q_vc[r] < q_vc[r - 1]:
                flag(f"R={r}", f"view-change quorum shrinks from "
                     f"{q_vc[r-1]} (R={r-1}) to {q_vc[r]} (R={r})")
        if r > lo and (r - 1) in q_r:
            checked += 1
            if q_r[r] < q_r[r - 1]:
                flag(f"R={r}", f"replication quorum shrinks from "
                     f"{q_r[r-1]} (R={r-1}) to {q_r[r]} (R={r})")
    return findings, checked


def run_quorum(root) -> List[Finding]:
    """The `quorum` pass entry."""
    root = pathlib.Path(root)
    path = root / manifest.VSRLINT_DISPATCH[0]
    if not path.exists():
        return []
    findings, _ = prove_quorums(path, root)
    findings.sort(key=lambda f: (f.file, f.line, f.code))
    return findings
