"""Finding records and the checked-in baseline.

A Finding is one rule violation at one source location. Its `key()`
deliberately omits the line number so the baseline survives unrelated
edits to the same file: two findings are "the same" when the pass, file,
enclosing scope, subject (attribute / symbol), and rule code all match.
The baseline (baseline.json next to this module) lists keys of known,
triaged findings — intentional patterns that are cheaper to suppress
than to restructure. New findings are keys not in the baseline;
stale baseline entries (keys no longer produced)
are reported so the file shrinks instead of rotting.
"""

from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass(frozen=True)
class Finding:
    pass_name: str  # ownership | determinism | markers
    code: str  # stable rule id, e.g. "unlocked-access"
    file: str  # repo-relative posix path
    line: int  # 1-based source line (not part of the key)
    scope: str  # "Class.method", "module", ... (part of the key)
    subject: str  # attribute / symbol / marker the rule fired on
    message: str  # human-readable description
    extra: dict = field(default_factory=dict, compare=False, hash=False)

    def key(self) -> str:
        return f"{self.pass_name}:{self.code}:{self.file}:{self.scope}:{self.subject}"

    def to_dict(self) -> dict:
        return {
            "pass": self.pass_name,
            "code": self.code,
            "file": self.file,
            "line": self.line,
            "scope": self.scope,
            "subject": self.subject,
            "message": self.message,
            "key": self.key(),
        }

    def render(self) -> str:
        return (
            f"{self.file}:{self.line}: [{self.pass_name}/{self.code}] "
            f"{self.scope}: {self.message}"
        )


def baseline_path() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent / "baseline.json"


def load_baseline(path=None) -> Dict[str, str]:
    """key -> reason. Missing file = empty baseline."""
    p = pathlib.Path(path) if path is not None else baseline_path()
    if not p.exists():
        return {}
    data = json.loads(p.read_text())
    return {e["key"]: e.get("reason", "") for e in data}


def write_baseline(findings: List[Finding], path=None, reason: str = "") -> None:
    p = pathlib.Path(path) if path is not None else baseline_path()
    entries = []
    seen = set()
    for f in findings:
        k = f.key()
        if k in seen:
            continue
        seen.add(k)
        entries.append({"key": k, "reason": reason or f.message})
    p.write_text(json.dumps(entries, indent=2, sort_keys=True) + "\n")


def split_by_baseline(findings: List[Finding], baseline: Dict[str, str]):
    """(new, suppressed, stale_keys): findings not in the baseline, those
    it covers, and baseline keys nothing produced this run."""
    produced = {f.key() for f in findings}
    new = [f for f in findings if f.key() not in baseline]
    suppressed = [f for f in findings if f.key() in baseline]
    stale = sorted(k for k in baseline if k not in produced)
    return new, suppressed, stale
