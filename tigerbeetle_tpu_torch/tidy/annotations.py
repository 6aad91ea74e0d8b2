"""Structured `# tidy:` source annotations.

The ownership pass is driven by declarations that live next to the code
they govern (the manifest-in-source approach — the annotation IS the
ownership comment, now machine-checked). Syntax, one or more
semicolon-separated clauses after `# tidy:`:

    self._pending = deque()   # tidy: guarded-by=_cond
    self._deferred_store = None  # tidy: owner=commit
    self._done = deque()      # tidy: atomic — GIL-atomic deque handoff
    def complete(self, job):  # tidy: thread=commit
    def _locked_pop(self):    # tidy: holds=_cond
    t = time.time()           # tidy: allow=wall-clock telemetry only

Clause grammar: `key` or `key=value`, where value runs to the next `;`
or an ` — `/` -- ` dash (free-text reason). Role and lock values may be
`|`-joined sets (`owner=commit|store`). Unknown keys are findings in
their own right (a typo'd annotation must not silently disable a rule).
"""

from __future__ import annotations

import io
import tokenize
from typing import Dict, List, Tuple

PREFIX = "tidy:"

# Keys the passes understand. `allow` values name a rule code (or a pass
# name) being waived on that line; everything else declares structure.
# `range` (native-absint, in C comments) declares entry intervals:
# `range=name:lo..hi,other:lo..hi`;
# `monotonic` (vsrlint) sanctions an assignment to a monotone protocol
# field the prover cannot discharge: `monotonic=view — reason` on the
# line (or on a def, blessing the whole bump helper).
KNOWN_KEYS = frozenset((
    "owner", "guarded-by", "atomic", "thread", "holds", "allow", "barrier",
    "init", "range", "monotonic",
))


class LineAnnotations:
    """Parsed clauses of one source line's tidy comment. `own_line` is
    True for a comment-only line — such an annotation binds to the NEXT
    source line (declarations too long for a trailing comment)."""

    __slots__ = ("line", "clauses", "reason", "own_line")

    def __init__(
        self, line: int, clauses: Dict[str, str], reason: str,
        own_line: bool = False,
    ) -> None:
        self.line = line
        self.clauses = clauses
        self.reason = reason
        self.own_line = own_line

    def roles(self, key: str) -> frozenset:
        v = self.clauses.get(key)
        return frozenset(p.strip() for p in v.split("|") if p.strip()) if v else frozenset()

    def allows(self, code: str) -> bool:
        v = self.clauses.get("allow")
        if v is None:
            return False
        allowed = {p.strip() for p in v.split("|")}
        return code in allowed or "*" in allowed

    def __contains__(self, key: str) -> bool:
        return key in self.clauses


def _parse_comment(text: str) -> Tuple[Dict[str, str], str]:
    """Clauses + trailing free-text reason from one comment body."""
    # Split a trailing reason off at an em-dash or double-hyphen.
    reason = ""
    for dash in (" — ", " -- "):
        if dash in text:
            text, reason = text.split(dash, 1)
            break
    clauses: Dict[str, str] = {}
    for part in text.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            k, v = part.split("=", 1)
            clauses[k.strip()] = v.strip()
        else:
            clauses[part] = ""
    return clauses, reason.strip()


def collect(source: str) -> Dict[int, LineAnnotations]:
    """line number -> parsed tidy annotations for one file's source."""
    out: Dict[int, LineAnnotations] = {}
    lines = source.splitlines()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            body = tok.string.lstrip("#").strip()
            if not body.startswith(PREFIX):
                continue
            clauses, reason = _parse_comment(body[len(PREFIX):].strip())
            n = tok.start[0]
            own = n <= len(lines) and lines[n - 1].lstrip().startswith("#")
            out[n] = LineAnnotations(n, clauses, reason, own_line=own)
    except tokenize.TokenError:
        pass  # syntactically broken file: the AST pass will fail loudly
    return out


def lookup(anns: Dict[int, LineAnnotations], line: int):
    """The annotations governing `line`: a trailing comment on the line
    itself, else a comment-only annotation line directly above."""
    a = anns.get(line)
    if a is not None:
        return a
    prev = anns.get(line - 1)
    if prev is not None and prev.own_line:
        return prev
    return None


def unknown_key_findings(path_rel: str, anns: Dict[int, LineAnnotations]) -> List:
    """A typo'd clause key must be a finding, never a silent no-op."""
    from tigerbeetle_tpu_torch.tidy.findings import Finding

    out = []
    for line, ann in sorted(anns.items()):
        for key in ann.clauses:
            if key not in KNOWN_KEYS:
                out.append(
                    Finding(
                        pass_name="ownership",
                        code="unknown-annotation",
                        file=path_rel,
                        line=line,
                        scope="module",
                        subject=key,
                        message=f"unknown tidy annotation key {key!r}"
                        f" (known: {', '.join(sorted(KNOWN_KEYS))})",
                    )
                )
    return out
