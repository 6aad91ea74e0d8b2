"""The port's static analysis and the dynamic leg of its tidy checks.

The static passes hold the port's code to the invariants the reference
package's tidy gate checks on its own, pointed at this package's files
(tidy/manifest.py names every scope):

  - `ownership` (tidy/ownership.py) — a lockset pass over the classes
    and module globals that the event loop, the WAL writer, the commit
    thread and the store thread share, driven by `# tidy:` annotations
    (`owner=`, `guarded-by=`, `atomic`, `thread=`, `holds=`).
  - `determinism` (tidy/determinism.py) — no wall clock, entropy
    (torch's global generator included), environment read, id() key,
    set-order iteration or float accumulation in models/, lsm/, vsr/
    (minus clock.py) and ops/.
  - `markers` (tidy/markers.py) — no stub or debug markers in the port's
    files, and a docstring on every package module.
  - `host-sync` / `reduction` (tidy/synclint.py) — no hidden wait on the
    card outside the dispatch/finish seam, and no float dtype or
    float reduction on the ledger's integer path.
  - `native-layout` / `native-abi` / `native-absint` (tidy/nativecheck.py,
    tidy/cparse.py) — the C sources' wire-layout constants against the
    port's dtypes, every ctypes binding (native/__init__.py, and
    ops/kernels.py SIGNATURES against the CUDA sources' `extern "C"`
    prototypes) against its C prototype, and the bounds of the C scan
    and gallop loops.
  - `absint` (tidy/absint.py) — the interval proof of the limb
    arithmetic: the plain u128 on its int64 carrier, the fold56 key
    builds, and the CUDA device helpers that carry the kernels' u128 and
    fold56 arithmetic (manifest.ABSINT_TARGETS, ABSINT_CUDA_FUNCS): no
    add, product, shift or implicit conversion leaves its width unless a
    `tidy: allow=` says why.
  - `vsrlint` / `quorum` (tidy/vsrlint.py) — handler exhaustiveness over
    the Command enum, wire-taint into replica state, monotone view/op/
    commit positions, quorum intersection for 1-6 replicas.
  - `protomodel` (tidy/protomodel.py) — a bounded model check of the
    view-change/commit transition system.

A finding is waived inline (`# tidy: allow=<code> <reason>`) or in
tidy/baseline.json, which is empty. Run the gate with
`python -m tigerbeetle_tpu_torch.tidy [--json] [--passes ...]`.

tidy/runtime.py is the dynamic leg: thread-role stamps, `assert_role`
and lock-order tracking, off unless enabled.
"""

from tigerbeetle_tpu_torch.tidy.findings import baseline_path, load_baseline  # noqa: F401


def all_pass_names():
    """Ordered tuple of every registered static pass."""
    return (
        "ownership", "determinism", "markers", "host-sync", "reduction",
        "native-layout", "native-abi", "native-absint", "absint",
        "vsrlint", "quorum", "protomodel",
    )


# host-sync and reduction share one module analysis, so they form one
# work unit.
_SYNC_PAIR = ("host-sync", "reduction")


def _expand_selection(passes):
    selected = list(passes) if passes is not None else list(all_pass_names())
    if "native" in selected:
        selected = [p for p in selected if p != "native"] + [
            "native-layout", "native-abi", "native-absint",
        ]
    unknown = [p for p in selected if p not in all_pass_names()]
    if unknown:
        # A typo must never silently disable a pass.
        raise ValueError(
            f"unknown tidy pass(es) {unknown!r}; known: {all_pass_names()}"
        )
    return selected


def _work_units(selected):
    units = []
    sync = tuple(p for p in selected if p in _SYNC_PAIR)
    if sync:
        units.append(("synclint[" + ",".join(sync) + "]", ("sync", sync)))
    for name in selected:
        if name not in _SYNC_PAIR:
            units.append((name, ("pass", name)))
    return units


def _run_unit(root_str, unit):
    """One work unit -> (findings, wall seconds)."""
    import pathlib
    import time

    from tigerbeetle_tpu_torch.tidy import (
        absint, determinism, markers, nativecheck, ownership, protomodel,
        synclint, vsrlint,
    )

    root = pathlib.Path(root_str)
    t0 = time.perf_counter()
    kind, payload = unit
    if kind == "sync":
        findings = synclint.run_selected(root, payload)
    else:
        table = {
            "ownership": ownership.run,
            "determinism": determinism.run,
            "markers": markers.run,
            "native-layout": nativecheck.run_layout,
            "native-abi": nativecheck.run_abi,
            "native-absint": nativecheck.run_absint,
            "absint": absint.run,
            "vsrlint": vsrlint.run,
            "quorum": vsrlint.run_quorum,
            "protomodel": protomodel.run,
        }
        findings = table[payload](root)
    return findings, time.perf_counter() - t0


def run_passes_timed(root=None, passes=None):
    """Run the selected passes (default: all) over the repo rooted at
    `root` (default: the checkout holding this package); returns
    (findings sorted by file and line, {work unit: wall seconds})."""
    import pathlib

    if root is None:
        root = pathlib.Path(__file__).resolve().parents[2]
    findings, timings = [], {}
    for name, unit in _work_units(_expand_selection(passes)):
        fs, dt = _run_unit(str(root), unit)
        findings.extend(fs)
        timings[name] = dt
    findings.sort(key=lambda f: (f.file, f.line, f.code))
    return findings, timings


def run_passes(root=None, passes=None):
    findings, _timings = run_passes_timed(root, passes)
    return findings


def check(root=None, passes=None, baseline_file=None) -> dict:
    """Run the passes and split their findings by the baseline: the
    report `python -m tigerbeetle_tpu_torch.tidy --json` prints."""
    import pathlib

    from tigerbeetle_tpu_torch.tidy.findings import split_by_baseline

    root = (pathlib.Path(root) if root is not None
            else pathlib.Path(__file__).resolve().parents[2])
    findings, timings = run_passes_timed(root, passes)
    new, suppressed, stale = split_by_baseline(
        findings, load_baseline(baseline_file)
    )
    return {
        "root": str(root),
        "passes": _expand_selection(passes),
        "findings": [f.to_dict() for f in findings],
        "new": [f.to_dict() for f in new],
        "suppressed": [f.to_dict() for f in suppressed],
        "stale_baseline_keys": stale,
        "ok": not new and not stale,
        "timings": {k: round(v, 3) for k, v in timings.items()},
        "parallel": False,
    }
