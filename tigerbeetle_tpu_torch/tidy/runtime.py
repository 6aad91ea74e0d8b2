"""Runtime thread-affinity and lock-order assertions (the dynamic leg).

The static ownership pass checks what the source SAYS about thread
roles; this module checks what the process DOES. Enabled with
`enable()` before the pipeline objects are constructed (the port reads
no environment variable); disabled it is a null object in both senses
the tracer set the precedent for:

  - `stamp()` / `assert_role()` early-return on one module-global flag
    and allocate nothing;
  - `make_lock()` / `make_condition()` return PLAIN threading
    primitives when disabled — the production pipeline runs the exact
    same objects it runs without this module, so the disabled overhead
    is literally zero on every `with lock:` scope.

Enabled:

  - each pipeline worker stamps its thread with a role at the top of
    `_run` ("wal" / "commit" / "store"); the event loop (or the
    simulator main thread standing in for it) stamps "loop". The role
    vocabulary is manifest.ROLES — "commit" means the commit-execution
    CONTEXT, which is the event loop itself on the serial fallback, so
    serial mode stamps nothing extra and `assert_role("commit",
    "loop")` reads as "commit context".
  - `assert_role(*roles)` at a hot-path entry raises AssertionError
    when the calling thread is stamped with a role outside the set
    (unstamped threads — arbitrary test callers — pass).
  - tracked locks record a per-thread held stack and a global
    acquisition-order graph; acquiring B while holding A adds edge
    A→B and raises on any path B→…→A (inconsistent lock order = a
    latent deadlock even if it never fires in this run).

The replica parity tests (tests/test_torch_cluster.py) enable it around
cluster construction, so every full-pipeline run doubles as an affinity
and lock-order audit.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Set, Tuple

_enabled = False

_tls = threading.local()
_graph_lock = threading.Lock()
# Directed acquisition-order edges (outer_name, inner_name), with the
# first-seen site kept for the error message.
_edges: Dict[Tuple[str, str], str] = {}


def enable() -> None:
    """Turn assertions on. Locks/conditions created BEFORE this call
    remain untracked (construction picks plain primitives when off)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset_order_graph() -> None:
    """Forget recorded acquisition-order edges (test isolation)."""
    with _graph_lock:
        _edges.clear()


# --- thread affinity ----------------------------------------------------


def stamp(role: str) -> None:
    """Stamp the CURRENT thread with a pipeline role. Cheap no-op when
    disabled; re-stamping (a promoted loop, a test harness) overwrites."""
    if not _enabled:
        return
    _tls.role = role


def current_role() -> Optional[str]:
    return getattr(_tls, "role", None) if _enabled else None


def assert_role(*roles: str) -> None:
    """Assert the calling thread is stamped with one of `roles` (or not
    stamped at all — arbitrary test/tool threads are exempt)."""
    if not _enabled:
        return
    role = getattr(_tls, "role", None)
    if role is not None and role not in roles:
        raise AssertionError(
            f"tidy: thread {threading.current_thread().name!r} (role "
            f"{role!r}) entered a path owned by {'|'.join(roles)}"
        )


# --- lock-order tracking ------------------------------------------------


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _note_acquire(name: str) -> None:
    held = _held()
    if name in held:  # re-entrant (Condition's RLock): no new edges
        held.append(name)
        return
    site = threading.current_thread().name
    with _graph_lock:
        for outer in held:
            if outer == name:
                continue
            edge = (outer, name)
            if edge not in _edges:
                # Adding outer→name: any existing path name→…→outer is
                # an inversion (cycle) — assert before recording.
                _assert_no_path(name, outer, edge)
                _edges[edge] = site
    held.append(name)


def _assert_no_path(src: str, dst: str, new_edge) -> None:
    stack = [src]
    seen: Set[str] = set()
    while stack:
        cur = stack.pop()
        if cur == dst:
            raise AssertionError(
                f"tidy: lock-order inversion — acquiring {new_edge[1]!r} "
                f"while holding {new_edge[0]!r}, but {src!r}→{dst!r} was "
                f"previously acquired in the opposite order (first seen on "
                f"thread {_edges.get((src, dst), '?')!r}); edges: "
                f"{sorted(_edges)}"
            )
        if cur in seen:
            continue
        seen.add(cur)
        for a, b in _edges:
            if a == cur:
                stack.append(b)
    return


def _note_release(name: str) -> None:
    held = _held()
    # Release the most recent matching acquisition (supports re-entrancy
    # and out-of-order release, which threading allows).
    for i in range(len(held) - 1, -1, -1):
        if held[i] == name:
            del held[i]
            return


class _TrackedCondition(threading.Condition):
    """threading.Condition recording acquisition order under its name."""

    def __init__(self, name: str, lock=None) -> None:
        super().__init__(lock)
        self.tidy_name = name

    def __enter__(self):
        r = super().__enter__()
        _note_acquire(self.tidy_name)
        return r

    def __exit__(self, *exc):
        _note_release(self.tidy_name)
        return super().__exit__(*exc)


class _TrackedLock:
    """Mutex wrapper recording acquisition order under its name."""

    def __init__(self, name: str) -> None:
        self._lock = threading.Lock()
        self.tidy_name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _note_acquire(self.tidy_name)
        return ok

    def release(self) -> None:
        _note_release(self.tidy_name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def make_condition(name: str):
    """A Condition for a pipeline stage: plain when disabled (zero
    overhead — the same object production runs), order-tracked when
    enabled. Decided at CONSTRUCTION: enable() before building the
    cluster/replica for tracking."""
    return _TrackedCondition(name) if _enabled else threading.Condition()


def make_lock(name: str):
    """A mutex with the same construction-time contract."""
    return _TrackedLock(name) if _enabled else threading.Lock()
