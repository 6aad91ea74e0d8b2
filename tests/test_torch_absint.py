"""The port's interval proof of its limb arithmetic (tidy/absint.py).

Three things are held here:

  - the port's targets (manifest.ABSINT_TARGETS: the plain u128 on its
    int64 carrier, the fold56 key build, the device key build's words;
    manifest.ABSINT_CUDA_FUNCS: the CUDA device helpers that carry the
    kernels' u128 and fold56 arithmetic) prove with no finding, and each
    file's checked-operation count stays at or above its floor, so the
    interpreter visited the arithmetic instead of skipping it;
  - each seeded fixture under tests/fixtures/tidy_torch/absint/ gives
    exactly its finding: a CUDA add that can wrap, the same add with an
    `allow=`, a violated callee `range=`, a signed-carrier underflow, and
    a loop the CUDA front end cannot read (it fails closed);
  - on the reference package's own numpy and limb files, which both front
    ends read, the port's pass (given the text) gives the reference
    pass's findings and checked count.
"""

import functools
import pathlib
from collections import defaultdict

import pytest

from tigerbeetle_tpu.tidy import absint as ref_absint
from tigerbeetle_tpu_torch import tidy
from tigerbeetle_tpu_torch.tidy import absint, cparse, manifest

REPO = pathlib.Path(__file__).resolve().parents[1]
FIX = REPO / "tests" / "fixtures" / "tidy_torch" / "absint"

# Checked operations per target file at this tree (the sums of each CUDA
# file's listed functions): a drop means arithmetic left the proof. A CUDA
# count holds each add, subtract, multiply, shift, division, address
# offset, conversion between integer types and callee range obligation
# once where it is evaluated (a condition's arithmetic is not counted
# again when a branch narrows on it).
FLOORS = {
    "tigerbeetle_tpu_torch/ops/u128.py": 42,
    "tigerbeetle_tpu_torch/lsm/scan.py": 2,
    "tigerbeetle_tpu_torch/ops/qindex.py": 8,
    "tigerbeetle_tpu_torch/csrc/common.cuh": 35,
    "tigerbeetle_tpu_torch/csrc/qindex_fold.cuh": 13,
    "tigerbeetle_tpu_torch/csrc/ladder.cuh": 21,
    "tigerbeetle_tpu_torch/csrc/create_transfers_exact.cu": 770,
    "tigerbeetle_tpu_torch/csrc/sharded_apply.cu": 253,
    "tigerbeetle_tpu_torch/csrc/create_transfers_fast.cu": 34,
}


@functools.lru_cache(maxsize=1)
def _by_file():
    counts, findings = defaultdict(int), []
    for key, (fs, n) in absint.run_counts(REPO).items():
        counts[key.split("::")[0]] += n
        findings.extend(fs)
    return counts, findings


def test_port_targets_prove_with_no_finding():
    counts, findings = _by_file()
    assert findings == []
    assert set(counts) == set(FLOORS)


@pytest.mark.parametrize("rel", sorted(FLOORS))
def test_checked_operations_at_or_above_floor(rel):
    counts, _ = _by_file()
    assert counts[rel] >= FLOORS[rel], (rel, counts[rel])


def test_gate_runs_absint_clean():
    assert "absint" in tidy.all_pass_names()
    assert tidy.run_passes(REPO, ["absint"]) == []


def test_every_listed_cuda_function_parses_and_is_visited():
    """Every listed device function is found and read in the subset; the
    ones with arithmetic count it (a parse failure is a c-parse finding,
    never a silent skip)."""
    for rel, fname in manifest.ABSINT_CUDA_FUNCS:
        fs, n = absint.prove_cuda_function(REPO / rel, rel, fname)
        assert fs == [], (fname, fs)
    for fname in ("sum_overflows", "atomic_add_u128", "atomic_sub_u128",
                  "add3", "ladder", "block_key"):
        rel = next(r for r, f in manifest.ABSINT_CUDA_FUNCS if f == fname)
        assert absint.prove_cuda_function(REPO / rel, rel, fname)[1] > 0


def test_loop_fails_closed():
    """A loop the front end cannot read (a range-based for) is a c-parse
    finding; a loop it reads is proven (tests/test_torch_absint_kernels.py)."""
    fs, n = absint.prove_cuda_function(FIX / "wrap_add.cuh", "wrap_add.cuh",
                                       "loops_unread")
    assert [(f.code, f.line) for f in fs] == [("c-parse", 36)] and n == 0


def test_missing_listed_function_is_a_finding():
    fs, n = absint.prove_cuda_function(
        FIX / "wrap_add.cuh", "wrap_add.cuh", "no_such_function")
    assert [f.code for f in fs] == ["c-parse"] and n == 0


# --- seeded fixtures --------------------------------------------------------


@pytest.mark.parametrize("fname,expect", [
    ("wraps", [("limb-overflow", 10)]),
    ("wraps_on_purpose", []),
    ("fits", []),
])
def test_cuda_add_fixture(fname, expect):
    fs, n = absint.prove_cuda_function(FIX / "wrap_add.cuh", "wrap_add.cuh",
                                       fname)
    assert [(f.code, f.line) for f in fs] == expect
    assert n == 1


@pytest.mark.parametrize("fname,expect", [
    ("bad_caller", [("range-obligation", 15, "top_byte.tag")]),
    ("good_caller", []),
    ("top_byte", []),
])
def test_cuda_range_obligation_fixture(fname, expect):
    fs, _ = absint.prove_cuda_function(
        FIX / "obligation.cuh", "obligation.cuh", fname)
    assert [(f.code, f.line, f.subject) for f in fs] == expect


def test_signed_carrier_underflow_fixture():
    fs, n = absint.prove_file(FIX / "carrier.py", REPO, "i64")
    assert [(f.code, f.line, f.scope) for f in fs] == [
        ("limb-underflow", 9, "unbounded")]
    assert n == 3  # the two subtractions and the borrow's mask


def test_cuda_subset_reads_the_device_helpers():
    """The C++ the helpers use: namespaces are transparent, reference
    parameters and __int128 typedefs keep their types, casts keep their
    target type."""
    src = (REPO / "tigerbeetle_tpu_torch/csrc/qindex_fold.cuh").read_text()
    fns = {f.name: f for f in cparse.parse_functions(src)}
    assert {"tag_of", "fold56_u64", "fold56_u128", "block_key"} <= set(fns)
    refs = [p.name for p in fns["fold56_u64"].params if p.ref]
    assert refs == ["f0", "f1"]
    common = (REPO / "tigerbeetle_tpu_torch/csrc/common.cuh").read_text()
    assert cparse.typedef_types(common)["u128"].width == 128
    assert [f for f, _ in cparse.collect_structs(common)["Wide"]] == ["lo", "hi"]
    toks, _ = cparse.lex("{ return (unsigned long long)x + "
                         "reinterpret_cast<unsigned long long*>(p)[0]; }")
    body = cparse.parse_body(toks, (0, len(toks) - 1), frozenset())
    ret = body.stmts[0].e
    assert ret.l.ctype.width == 64 and ret.r.base.ctype.ptr == 1


# --- parity with the reference pass -----------------------------------------


@pytest.mark.parametrize("rel,width", [
    ("tigerbeetle_tpu/lsm/scan.py", 64),
    ("tigerbeetle_tpu/ops/u128.py", 32),
    ("tigerbeetle_tpu/ops/qindex.py", 32),
])
def test_parity_with_reference_pass(rel, width):
    ref_findings, ref_n = ref_absint.prove_file(REPO / rel, REPO, width)
    text = (REPO / rel).read_text()
    port_findings, port_n = absint.prove_file(REPO / rel, REPO, f"u{width}",
                                              source=text)
    assert port_n == ref_n
    assert [(f.code, f.line, f.scope, f.subject) for f in port_findings] == [
        (f.code, f.line, f.scope, f.subject) for f in ref_findings]
