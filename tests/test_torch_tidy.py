"""The port's static-analysis gate (tigerbeetle_tpu_torch/tidy/).

The whole port has no finding over any registered pass, and the gate's
`--json` entry keeps the reference's report schema and exit codes. Each
pass ported from the reference package gives the reference's findings,
as (pass, code, line), on the reference's own fixtures
(tests/fixtures/{tidy,vsrlint,nativecheck}/), and the marker scan on
tests/fixtures/tidy_torch/markers_bad.py (the reference has no marker
fixture): those fixtures sit outside both manifests, so the two
packages' scopes do not differ there.

The port's own passes have fixtures of their own under
tests/fixtures/tidy_torch/: the sync lint (host-sync, reduction; the
reference's jaxlint fixtures lint jit-traced JAX code, which the port
has none of) and the check of the CUDA kernels' ctypes bindings against
their `extern "C"` prototypes.
"""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

from tigerbeetle_tpu.tidy import cparse as ref_cparse
from tigerbeetle_tpu.tidy import determinism as ref_determinism
from tigerbeetle_tpu.tidy import markers as ref_markers
from tigerbeetle_tpu.tidy import nativecheck as ref_nativecheck
from tigerbeetle_tpu.tidy import ownership as ref_ownership
from tigerbeetle_tpu.tidy import vsrlint as ref_vsrlint
from tigerbeetle_tpu_torch import tidy
from tigerbeetle_tpu_torch.tidy import annotations as ann_mod
from tigerbeetle_tpu_torch.tidy import (
    cparse, determinism, manifest, markers, nativecheck, ownership,
    synclint, vsrlint,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
FIX = REPO / "tests" / "fixtures"
OWN = FIX / "tidy_torch"

ALL_PASSES = [
    "ownership", "determinism", "markers", "host-sync", "reduction",
    "native-layout", "native-abi", "native-absint", "absint", "vsrlint",
    "quorum", "protomodel",
]


def _key(findings):
    return sorted((f.pass_name, f.code, f.line) for f in findings)


# --- the whole port --------------------------------------------------------


def test_port_has_no_findings_over_every_pass():
    report = tidy.check(REPO)
    assert report["passes"] == ALL_PASSES
    assert set(report["timings"]) == {
        "synclint[host-sync,reduction]", *(p for p in ALL_PASSES
                                           if p not in ("host-sync", "reduction")),
    }
    assert report["findings"] == [], [
        f"{f['file']}:{f['line']} {f['code']} {f['message']}"
        for f in report["findings"]
    ]
    assert report["ok"] and report["stale_baseline_keys"] == []
    assert json.loads(tidy.baseline_path().read_text()) == []


def test_json_entry_schema_and_exit_codes(tmp_path):
    cmd = [sys.executable, "-m", "tigerbeetle_tpu_torch.tidy", "--json",
           "--passes", "markers", "quorum"]
    ok = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0, ok.stderr
    report = json.loads(ok.stdout)
    # The reference's tools/check.py --json report, key for key.
    assert set(report) == {
        "root", "passes", "findings", "new", "suppressed",
        "stale_baseline_keys", "ok", "timings", "parallel", "devhub", "codec",
    }
    assert report["passes"] == ["markers", "quorum"] and report["ok"] is True
    assert report["codec"]["failures"] == []
    # A baseline key that nothing produces is stale: the gate fails.
    stale = tmp_path / "baseline.json"
    stale.write_text(json.dumps([{"key": "markers|x.py|module|gone|banned-marker",
                                  "reason": "stale"}]))
    bad = subprocess.run(cmd + ["--baseline", str(stale)], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert bad.returncode == 1
    assert json.loads(bad.stdout)["stale_baseline_keys"] == [
        "markers|x.py|module|gone|banned-marker"
    ]
    with pytest.raises(ValueError):
        tidy.run_passes(REPO, ["ownrship"])


# --- parity with the reference on its fixtures -----------------------------

_LAYOUT_EXPECT = {
    "OFF_CHECKSUM": (0, "fixture table"),
    "OFF_SIZE": (80, "fixture table"),
    "HEADER_SIZE": (256, "fixture table"),
    "T_LEDGER": (52, "fixture table"),
    "OFF_GONE": (10, "fixture table"),
}


def _abi_exports(mod):
    fns = mod.parse_functions((FIX / "nativecheck" / "abi_shim.c").read_text())
    return {f.name: f for f in fns if not f.static}


PARITY = {
    "ownership_bad": (
        lambda: ref_ownership.analyze_file(FIX / "tidy" / "ownership_bad.py", REPO),
        lambda: ownership.analyze_file(FIX / "tidy" / "ownership_bad.py", REPO)),
    "determinism_bad": (
        lambda: ref_determinism.analyze_file(FIX / "tidy" / "determinism_bad.py", REPO),
        lambda: determinism.analyze_file(FIX / "tidy" / "determinism_bad.py", REPO)),
    "vsr_bad": (
        lambda: ref_vsrlint.analyze_file(FIX / "vsrlint" / "vsr_bad.py", REPO),
        lambda: vsrlint.analyze_file(FIX / "vsrlint" / "vsr_bad.py", REPO)),
    "vsr_ok": (
        lambda: ref_vsrlint.analyze_file(FIX / "vsrlint" / "vsr_ok.py", REPO),
        lambda: vsrlint.analyze_file(FIX / "vsrlint" / "vsr_ok.py", REPO)),
    "layout_bad": (
        lambda: ref_nativecheck.check_layout_file(
            FIX / "nativecheck" / "layout_bad.c", "fix/layout_bad.c", _LAYOUT_EXPECT),
        lambda: nativecheck.check_layout_file(
            FIX / "nativecheck" / "layout_bad.c", "fix/layout_bad.c", _LAYOUT_EXPECT)),
    "layout_clean": (
        lambda: ref_nativecheck.check_layout_file(
            FIX / "nativecheck" / "layout_clean.c", "fix/layout_clean.c", _LAYOUT_EXPECT),
        lambda: nativecheck.check_layout_file(
            FIX / "nativecheck" / "layout_clean.c", "fix/layout_clean.c", _LAYOUT_EXPECT)),
    "abi_bad": (
        lambda: ref_nativecheck.check_abi_decls(
            FIX / "nativecheck" / "abi_bad.py", "fix/abi_bad.py", _abi_exports(ref_cparse)),
        lambda: nativecheck.check_abi_decls(
            FIX / "nativecheck" / "abi_bad.py", "fix/abi_bad.py", _abi_exports(cparse))),
    "abi_clean": (
        lambda: ref_nativecheck.check_abi_decls(
            FIX / "nativecheck" / "abi_clean.py", "fix/abi_clean.py", _abi_exports(ref_cparse)),
        lambda: nativecheck.check_abi_decls(
            FIX / "nativecheck" / "abi_clean.py", "fix/abi_clean.py", _abi_exports(cparse))),
    "ptr_bad": (
        lambda: ref_nativecheck._lifetime_scan_file(FIX / "nativecheck" / "ptr_bad.py", "fix/ptr_bad.py"),
        lambda: nativecheck._lifetime_scan_file(FIX / "nativecheck" / "ptr_bad.py", "fix/ptr_bad.py")),
    "ptr_clean": (
        lambda: ref_nativecheck._lifetime_scan_file(FIX / "nativecheck" / "ptr_clean.py", "fix/ptr_clean.py"),
        lambda: nativecheck._lifetime_scan_file(FIX / "nativecheck" / "ptr_clean.py", "fix/ptr_clean.py")),
    "markers_bad": (
        lambda: ref_markers.scan_file(OWN / "markers_bad.py", REPO),
        lambda: markers.scan_file(OWN / "markers_bad.py", REPO)),
    "absint_bad": (
        lambda: ref_nativecheck.analyze_c_function(
            FIX / "nativecheck" / "absint_bad.c", "fix/absint_bad.c", "fx_oob")[0],
        lambda: nativecheck.analyze_c_function(
            FIX / "nativecheck" / "absint_bad.c", "fix/absint_bad.c", "fx_oob")[0]),
    "absint_clean": (
        lambda: ref_nativecheck.analyze_c_function(
            FIX / "nativecheck" / "absint_clean.c", "fix/absint_clean.c", "fx_inbounds")[0],
        lambda: nativecheck.analyze_c_function(
            FIX / "nativecheck" / "absint_clean.c", "fix/absint_clean.c", "fx_inbounds")[0]),
}

# How many findings each reference fixture seeds: parity must not hold
# vacuously on an empty pair.
SEEDED = {"ownership_bad": 3, "determinism_bad": 6, "vsr_bad": 5, "vsr_ok": 0,
          "layout_bad": 4, "layout_clean": 0, "abi_bad": 5, "abi_clean": 0,
          "ptr_bad": 2, "ptr_clean": 0, "absint_bad": 1, "absint_clean": 0,
          "markers_bad": 4}


@pytest.mark.parametrize("fixture", sorted(PARITY))
def test_reference_fixture_parity(fixture):
    ref, port = PARITY[fixture]
    want, got = _key(ref()), _key(port())
    assert got == want
    assert len(got) == SEEDED[fixture]


def test_vsrlint_and_quorum_cover_the_port_as_the_reference():
    """The protocol lints check at least as many taint sinks and
    monotone assignments in the port's VSR as in the reference's, and
    the quorum proof evaluates the same assertions."""
    for rel in ("vsr/replica.py", "vsr/journal.py", "vsr/superblock.py"):
        fs, taint, mono = vsrlint.analyze_file_counts(
            REPO / "tigerbeetle_tpu_torch" / rel, REPO)
        _, ref_taint, ref_mono = ref_vsrlint.analyze_file_counts(
            REPO / "tigerbeetle_tpu" / rel, REPO)
        assert fs == [] and taint >= ref_taint and mono >= ref_mono, rel
    port_q = vsrlint.prove_quorums(REPO / "tigerbeetle_tpu_torch/vsr/replica.py", REPO)
    ref_q = ref_vsrlint.prove_quorums(REPO / "tigerbeetle_tpu/vsr/replica.py", REPO)
    assert port_q[0] == [] and port_q[1] == ref_q[1] > 0
    header = REPO / manifest.VSRLINT_COMMAND_MODULE
    dispatch = REPO / manifest.VSRLINT_DISPATCH[0]
    fs, checked = vsrlint.check_exhaustiveness(header, dispatch, REPO)
    assert fs == [] and checked > 20


def test_native_layout_holds_the_port_dtypes_to_the_c_sources():
    """The parity table is built from the port's dtypes, and shifting any
    one constant against the real C sources is caught."""
    expect_all = nativecheck._layout_expectations()
    assert {k: {n: v[0] for n, v in t.items()} for k, t in expect_all.items()} == {
        k: {n: v[0] for n, v in t.items()}
        for k, t in ref_nativecheck._layout_expectations().items()}
    for rel in ("csrc/busio.c", "csrc/tb_client.c"):
        base = expect_all[rel]
        name, (want, truth) = sorted(base.items())[0]
        fs = nativecheck.check_layout_file(REPO / rel, rel, {**base, name: (want + 1, truth)})
        assert [(f.code, f.subject) for f in fs] == [("layout-parity", name)]


# --- the sync lint ---------------------------------------------------------

SYNC_BAD = [
    ("host-sync", "stale-seam", 1, "gone"),
    ("host-sync", "host-sync", 16, ".item()"),
    ("host-sync", "host-sync", 17, ".cpu()"),
    ("host-sync", "host-sync", 18, ".tolist()"),
    ("host-sync", "host-sync", 19, ".numpy()"),
    ("host-sync", "host-sync", 20, "bool()"),
    ("host-sync", "host-sync", 21, "int()"),
    ("host-sync", "host-sync", 22, "float()"),
    ("host-sync", "host-sync", 23, "torch.equal()"),
    ("host-sync", "host-sync", 24, '.to("cpu")'),
    ("host-sync", "host-sync", 25, '.to("cpu")'),
    ("host-sync", "host-sync", 27, ".copy_()"),
    ("host-sync", "device-branch", 29, "if"),
    ("host-sync", "device-branch", 31, "while"),
    ("host-sync", "device-branch", 33, "ifexp"),
    ("host-sync", "unfenced-sync", 34, "torch.cuda.synchronize"),
    ("host-sync", "unfenced-sync", 36, "ev.synchronize"),
    ("host-sync", "unfenced-sync", 37, "torch.cuda.current_stream().synchronize"),
    ("reduction", "float-dtype", 42, "torch.float32"),
    ("reduction", "unordered-reduce", 43, "index_add_"),
    ("reduction", "unordered-reduce", 44, "sum"),
    ("reduction", "float-dtype", 45, ".float()"),
]


def test_sync_fixture_exact_findings():
    """Every flagged form once; the non-blocking copy (line 28), the host
    tensors, the inline escape, the seam and the host-only function stay
    silent."""
    fs = synclint.analyze_file(OWN / "sync_bad.py", REPO, seam={"finish"},
                               host_only={"plain", "gone"})
    got = sorted((f.pass_name, f.code, f.line, f.subject) for f in fs)
    assert got == sorted(SYNC_BAD)
    # Without the seam and host-only declarations, those two are flagged.
    bare = synclint.analyze_file(OWN / "sync_bad.py", REPO)
    extra = {(f.scope, f.code) for f in bare} - {(f.scope, f.code) for f in fs}
    assert extra == {("finish", "host-sync"), ("plain", "host-sync")}
    only = synclint.analyze_file(OWN / "sync_bad.py", REPO, passes=("reduction",),
                                 seam={"finish"}, host_only={"plain"})
    assert {f.pass_name for f in only} == {"reduction"} and len(only) == 4


def test_a_value_reading_cost_row_is_flagged():
    """devicestats.py is in the hot set: a COSTS row that counts from the
    values of its tensors (a sync beside every launch) is flagged; the
    row that counts from shapes alone and the hot caller are not."""
    assert "tigerbeetle_tpu_torch/devicestats.py" in manifest.SYNCLINT_MODULES
    fs = synclint.analyze_file(OWN / "costs_bad.py", REPO)
    assert [(f.pass_name, f.code, f.line, f.scope, f.subject) for f in fs] == [
        ("host-sync", "host-sync", 9, "_landed", ".item()")]


def test_every_seam_holds_a_sync_and_the_rest_holds_none():
    """Each seam and host-only entry names a function that does wait on
    the card (else it would be a declaration with nothing to declare),
    and nothing else in the hot set does."""
    declared = set(manifest.SYNCLINT_SEAM) | set(manifest.SYNCLINT_HOST_ONLY)
    hit = set()
    for rel in manifest.SYNCLINT_MODULES:
        for f in synclint.analyze_file(REPO / rel, REPO):
            assert (rel, f.scope) in declared, f"{rel}:{f.line} {f.code} {f.scope}"
            hit.add((rel, f.scope))
    assert hit == declared


# --- the kernels' ctypes bindings ------------------------------------------


def test_kernel_binding_fixture_exact_findings():
    got = {}
    for name in ("kernels_bad.py", "kernels_clean.py"):
        fs = nativecheck.check_cu_bindings(OWN / name, f"fix/{name}", OWN / "cu", REPO,
                                           [OWN / name])
        got[name] = sorted((f.code, f.line, f.subject) for f in fs)
    assert got == {
        "kernels_bad.py": [("abi-type", 13, "tb_fx_scale[2]"),
                           ("abi-unknown-symbol", 15, "tb_fx_gone")],
        "kernels_clean.py": [],
    }


def test_native_abi_covers_every_kernel_entry(tmp_path):
    """All 20 SIGNATURES entries and both helper bindings resolve to a
    `.cu` prototype, and one argtype changed in a copy of ops/kernels.py
    is caught."""
    helpers = [REPO / h for h in manifest.NATIVE_CU_HELPER_CALLERS]
    py = REPO / manifest.NATIVE_CU_BINDINGS
    decls, errors = nativecheck._cu_decls(py, helpers)
    assert errors == []
    assert len([d for d, _s, w in decls if w == py]) == 20
    assert len(decls) == 22
    cu = REPO / manifest.NATIVE_CU_DIR
    assert nativecheck.check_cu_bindings(py, "k.py", cu, REPO, helpers) == []
    src = py.read_text()
    old = '"read_balances": ("tb_read_balances", [_P] * 6 + [_I, _I, _P]),'
    assert old in src
    bad = tmp_path / "kernels.py"
    bad.write_text(src.replace(old, old.replace("[_I, _I, _P]", "[_I, _P, _P]")))
    fs = nativecheck.check_cu_bindings(bad, "k.py", cu, REPO, helpers)
    assert [(f.code, f.subject) for f in fs] == [("abi-type", "tb_read_balances[7]")]


def test_cu_reader_reads_only_extern_c(tmp_path):
    """Templates, kernels and launches stay out of the C front end, and an
    `extern "C"` declaration it cannot read is a finding."""
    fns, fs = nativecheck.cu_exports(OWN / "cu" / "fx_kernel.cu", "fx.cu")
    assert sorted(fns) == ["tb_fx_scale", "tb_fx_scratch"] and fs == []
    bad = tmp_path / "bad.cu"
    bad.write_text('extern "C" {\nint tb_a(void* p);\n}\n')
    _fns, fs = nativecheck.cu_exports(bad, "bad.cu")
    assert [f.code for f in fs] == ["abi-extract"]


# --- the port's additions to the ported passes -----------------------------


def test_determinism_bans_torch_global_generator(tmp_path):
    f = tmp_path / "m.py"
    f.write_text(
        '"""Doc."""\n'
        "import torch\n"
        "from torch import randperm\n"
        "def f(n, g):\n"
        "    torch.manual_seed(1)\n"
        "    a = torch.rand(n)\n"
        "    b = torch.randint(0, 9, (n,), generator=g)\n"
        "    c = randperm(n)\n"
        "    d = torch.cuda.manual_seed_all(2)\n"
        "    return a, b, c, d\n"
    )
    fs = determinism.analyze_file(f, tmp_path)
    assert sorted((x.code, x.line, x.subject) for x in fs) == [
        ("random", 5, "torch.manual_seed"), ("random", 6, "torch.rand"),
        ("random", 8, "torch.randperm"), ("random", 9, "torch.cuda.manual_seed_all"),
    ]


def test_marker_scan_covers_the_port_files_only():
    files = {p.resolve() for p in markers._scan_files(REPO)}
    for rel in ("chip_smoke.py", "tests/test_torch_tidy.py", "tests/exact_batches.py",
                "tools/torch_kernel_ab.py", "tigerbeetle_tpu_torch/tidy/manifest.py"):
        assert (REPO / rel).resolve() in files, rel
    assert (REPO / "tests" / "test_tidy.py").resolve() not in files
    assert (OWN / "sync_bad.py").resolve() not in files


def test_ownership_covers_the_kernel_launch_counts():
    """ops/kernels.py's shared globals are declared, and an unlocked
    write of the launch counts is caught."""
    src = (REPO / "tigerbeetle_tpu_torch" / "ops" / "kernels.py").read_text()
    rel = "tigerbeetle_tpu_torch/ops/kernels.py"
    assert rel in manifest.OWNERSHIP_MODULES
    assert ownership.analyze_file(REPO / rel, REPO) == []
    old = "    with _count_lock:  # the replica's stage threads launch concurrently\n        LAUNCHES[name] += 1\n"
    assert old in src
    mutant = src.replace(old, "    LAUNCHES[name] += 1\n")
    fs = ownership._analyze_module(ast.parse(mutant), rel, ann_mod.collect(mutant), "any")
    assert [(f.code, f.subject) for f in fs] == [("unlocked-access", "LAUNCHES")] * 2
