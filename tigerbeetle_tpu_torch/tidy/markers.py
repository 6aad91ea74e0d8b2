"""Source-hygiene pass (the reference tidy.zig banned-word family).

Two rules:

  banned-marker      stub markers and debug leftovers
                     (manifest.BANNED_MARKERS) anywhere in the port's
                     package, its tests, tools and scripts. A
                     legitimate use (e.g. a test asserting on the
                     marker itself) carries `# tidy: allow=marker why`
                     on the line; fixture modules under tests/fixtures
                     are excluded wholesale — they exist to violate
                     rules.
  missing-docstring  every package module documents itself.
"""

from __future__ import annotations

import ast
import pathlib
from typing import List

from tigerbeetle_tpu_torch.tidy import annotations as ann_mod
from tigerbeetle_tpu_torch.tidy import manifest
from tigerbeetle_tpu_torch.tidy.findings import Finding


def _scan_files(root: pathlib.Path) -> List[pathlib.Path]:
    out: List[pathlib.Path] = []
    exclude = tuple((root / d).resolve() for d in manifest.MARKER_SCAN_EXCLUDE_DIRS)
    for d in manifest.MARKER_SCAN_DIRS:
        base = root / d
        if not base.exists():
            continue
        for path in sorted(base.rglob("*.py")):
            r = path.resolve()
            if "__pycache__" in path.parts:
                continue
            if any(str(r).startswith(str(e) + "/") for e in exclude):
                continue
            out.append(path)
    for pattern in manifest.MARKER_SCAN_GLOBS:
        out.extend(sorted(root.glob(pattern)))
    for f in manifest.MARKER_SCAN_FILES:
        path = root / f
        if path.exists():
            out.append(path)
    return out


def run(root) -> List[Finding]:
    root = pathlib.Path(root)
    findings: List[Finding] = []
    for path in _scan_files(root):
        findings.extend(scan_file(path, root))
    for d in manifest.DOCSTRING_SCAN_DIRS:
        for path in sorted((root / d).rglob("*.py")):
            if "__pycache__" in path.parts or path.name == "__init__.py":
                continue
            rel = path.resolve().relative_to(root.resolve()).as_posix()
            tree = ast.parse(path.read_text())
            if ast.get_docstring(tree) is None:
                findings.append(Finding(
                    "markers", "missing-docstring", rel, 1, "module", path.name,
                    "module has no docstring",
                ))
    return findings


def scan_file(path, root) -> List[Finding]:
    path = pathlib.Path(path)
    root = pathlib.Path(root)
    text = path.read_text()
    rel = path.resolve().relative_to(root.resolve()).as_posix()
    anns = ann_mod.collect(text)
    findings: List[Finding] = []
    for i, line in enumerate(text.splitlines(), 1):
        for banned in manifest.BANNED_MARKERS:
            if banned not in line:
                continue
            a = ann_mod.lookup(anns, i)
            if a is not None and (a.allows("marker") or a.allows("markers")):
                continue
            findings.append(Finding(
                "markers", "banned-marker", rel, i, "module", banned,
                f"banned marker {banned!r}",
            ))
    return findings
