"""Determinism lint over the deterministic core.

The paper's core claim — every replica is a pure function of
(state, ordered batch) — survives only if nothing in models/, lsm/,
vsr/ (minus clock.py, the one sanctioned wall-clock reader), or ops/
reads ambient nondeterminism. Banned, each with its own rule code:

  wall-clock   time.time/.time_ns/.monotonic*/.perf_counter*/
               clock_gettime, datetime.now/utcnow/today — wall and
               monotonic clocks differ across replicas and runs.
  random       random.*, numpy.random.*, os.urandom, uuid.*,
               secrets.* — any entropy source.
  random       (torch) torch's global generator: torch.manual_seed,
               torch.seed, torch.cuda.manual_seed*, and torch.rand* /
               randn* / randint* / randperm / normal / bernoulli /
               multinomial / poisson without `generator=`. A seeded
               torch.Generator passed explicitly is deterministic; the
               global one is shared by every caller in the process.
  env-read     os.environ / os.getenv — configuration must arrive
               through explicit, cluster-uniform parameters.
  id-key       builtin id() — CPython addresses differ across runs;
               an id()-derived value that reaches ordering, keying, or
               serialization diverges replicas.
  set-iter     iterating a set/frozenset literal or constructor
               directly — set iteration order is salted per process;
               wrap in sorted().
  float-acc    augmented float accumulation onto instance state —
               float addition is not associative, so accumulation
               order (which threading can vary) changes state bytes.

Suppress a justified use inline: `# tidy: allow=<code> reason` on the
line (or the enclosing def). The lint is lexical: aliased module
imports are resolved (`import numpy as np` → `np.random` matches), but
values smuggled through locals are not chased.
"""

from __future__ import annotations

import ast
import pathlib
from typing import Dict, List, Optional

from tigerbeetle_tpu_torch.tidy import annotations as ann_mod
from tigerbeetle_tpu_torch.tidy import manifest
from tigerbeetle_tpu_torch.tidy.findings import Finding

# Fully-dotted callable prefixes → rule code. A call matches when its
# resolved dotted name equals an entry or extends a trailing-dot prefix.
BANNED_CALLS = {
    "time.time": "wall-clock",
    "time.time_ns": "wall-clock",
    "time.monotonic": "wall-clock",
    "time.monotonic_ns": "wall-clock",
    "time.perf_counter": "wall-clock",
    "time.perf_counter_ns": "wall-clock",
    "time.clock_gettime": "wall-clock",
    "time.clock_gettime_ns": "wall-clock",
    "datetime.datetime.now": "wall-clock",
    "datetime.datetime.utcnow": "wall-clock",
    "datetime.datetime.today": "wall-clock",
    "datetime.date.today": "wall-clock",
    "random.": "random",
    "numpy.random.": "random",
    "os.urandom": "random",
    "uuid.uuid1": "random",
    "uuid.uuid4": "random",
    "secrets.": "random",
    "os.getenv": "env-read",
}

# torch's global-generator seeding: banned outright.
TORCH_SEEDING = frozenset((
    "torch.manual_seed", "torch.seed", "torch.initial_seed",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all", "torch.cuda.seed",
    "torch.cuda.seed_all", "torch.random.manual_seed", "torch.random.seed",
))
# torch's sampling functions: banned unless they pass `generator=`.
TORCH_SAMPLERS = frozenset((
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "normal", "bernoulli", "multinomial", "poisson",
))

MODULE_ALIAS_TARGETS = (
    "time", "random", "os", "uuid", "secrets", "datetime", "numpy", "torch",
)


def run(root) -> List[Finding]:
    root = pathlib.Path(root)
    findings: List[Finding] = []
    include = [root / p for p in manifest.DETERMINISM_INCLUDE]
    exclude = {(root / p).resolve() for p in manifest.DETERMINISM_EXCLUDE}
    for base in include:
        for path in sorted(base.rglob("*.py")):
            if "__pycache__" in path.parts or path.resolve() in exclude:
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
    v = _Visitor(rel, anns)
    v.visit(tree)
    return v.findings


class _Visitor(ast.NodeVisitor):
    def __init__(self, rel: str, anns) -> None:
        self.rel = rel
        self.anns = anns
        self.findings: List[Finding] = []
        # local alias -> real module dotted name ("np" -> "numpy")
        self.aliases: Dict[str, str] = {}
        # name imported FROM a module -> dotted origin ("time" from
        # `from time import time` -> "time.time")
        self.from_imports: Dict[str, str] = {}
        self.scope_stack: List[str] = []
        self.def_line_stack: List[int] = []

    # --- bookkeeping ------------------------------------------------------

    def visit_Import(self, node) -> None:
        for a in node.names:
            top = a.name.split(".")[0]
            if top in MODULE_ALIAS_TARGETS:
                self.aliases[a.asname or a.name.split(".")[0]] = a.name

    def visit_ImportFrom(self, node) -> None:
        if node.module and node.module.split(".")[0] in MODULE_ALIAS_TARGETS:
            for a in node.names:
                self.from_imports[a.asname or a.name] = f"{node.module}.{a.name}"

    def visit_FunctionDef(self, node) -> None:
        self.scope_stack.append(node.name)
        self.def_line_stack.append(node.lineno)
        self.generic_visit(node)
        self.scope_stack.pop()
        self.def_line_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node) -> None:
        self.scope_stack.append(node.name)
        self.generic_visit(node)
        self.scope_stack.pop()

    # --- reporting --------------------------------------------------------

    def _scope(self) -> str:
        return ".".join(self.scope_stack) or "module"

    def _suppressed(self, line: int, code: str) -> bool:
        lines = [line]
        if self.def_line_stack:
            lines.append(self.def_line_stack[-1])
        for ln in lines:
            a = ann_mod.lookup(self.anns, ln)
            if a is not None and (a.allows(code) or a.allows("determinism")):
                return True
        return False

    def _flag(self, code: str, line: int, subject: str, message: str) -> None:
        if self._suppressed(line, code):
            return
        self.findings.append(Finding(
            "determinism", code, self.rel, line, self._scope(), subject, message,
        ))

    # --- name resolution --------------------------------------------------

    def _dotted(self, node) -> Optional[str]:
        parts: List[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        head = self.aliases.get(cur.id) or self.from_imports.get(cur.id)
        if head is None:
            # Unimported head: only meaningful for bare builtins (id).
            head = cur.id
        parts.append(head)
        return ".".join(reversed(parts))

    # --- rules ------------------------------------------------------------

    def visit_Call(self, node) -> None:
        dotted = self._dotted(node.func)
        if dotted is not None:
            code = self._banned_call(dotted)
            if code is not None:
                self._flag(code, node.lineno, dotted, f"call to {dotted}()")
            self._check_torch_random(node, dotted)
            if dotted == "id" and isinstance(node.func, ast.Name):
                self._flag(
                    "id-key", node.lineno, "id",
                    "builtin id() — identity-derived values diverge across "
                    "runs when keyed, ordered, or serialized",
                )
        self.generic_visit(node)

    def _check_torch_random(self, node, dotted: str) -> None:
        if dotted in TORCH_SEEDING:
            self._flag(
                "random", node.lineno, dotted,
                f"call to {dotted}() — seeds torch's process-global "
                "generator; pass a seeded torch.Generator instead",
            )
            return
        head, _, tail = dotted.rpartition(".")
        if head in ("torch", "torch.random") and tail in TORCH_SAMPLERS:
            if not any(k.arg == "generator" for k in node.keywords):
                self._flag(
                    "random", node.lineno, dotted,
                    f"call to {dotted}() without generator= — draws from "
                    "torch's process-global generator",
                )

    @staticmethod
    def _banned_call(dotted: str) -> Optional[str]:
        for prefix, code in BANNED_CALLS.items():
            if prefix.endswith("."):
                if dotted.startswith(prefix):
                    return code
            elif dotted == prefix:
                return code
        return None

    def visit_Attribute(self, node) -> None:
        dotted = self._dotted(node)
        if dotted == "os.environ":
            self._flag("env-read", node.lineno, dotted, "os.environ access")
        self.generic_visit(node)

    def _check_iter(self, expr, line: int) -> None:
        target = expr
        # list(<set>), tuple(<set>), enumerate(<set>) — still set order.
        if (
            isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Name)
            and expr.func.id in ("list", "tuple", "enumerate", "iter")
            and expr.args
        ):
            target = expr.args[0]
        is_set = isinstance(target, ast.Set) or (
            isinstance(target, ast.Call)
            and isinstance(target.func, ast.Name)
            and target.func.id in ("set", "frozenset")
        )
        if is_set:
            self._flag(
                "set-iter", line, "set",
                "iteration over a set — per-process hash salting makes the "
                "order nondeterministic; wrap in sorted()",
            )

    def visit_For(self, node) -> None:
        self._check_iter(node.iter, node.iter.lineno)
        self.generic_visit(node)

    def visit_comprehension(self, node) -> None:
        self._check_iter(node.iter, node.iter.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node) -> None:
        t = node.target
        is_state = (
            isinstance(t, ast.Attribute)
            and isinstance(t.value, ast.Name)
            and t.value.id == "self"
        )
        if is_state and isinstance(node.op, (ast.Add, ast.Sub, ast.Mult)):
            if self._has_float(node.value):
                self._flag(
                    "float-acc", node.lineno, t.attr,
                    f"float accumulation onto self.{t.attr} — addition order "
                    "changes the result; accumulate integers (ns, counts) "
                    "and divide at the edge",
                )
        self.generic_visit(node)

    @staticmethod
    def _has_float(expr) -> bool:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, float):
                return True
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Name)
                and sub.func.id == "float"
            ):
                return True
        return False
