"""absint's proof of the commit kernels' own u128 arithmetic.

The CUDA front end of tidy/absint.py reads the commit kernels whole
(csrc/create_transfers_exact.cu, csrc/sharded_apply.cu,
csrc/create_transfers_fast.cu): loops (a constant trip count read one
iteration at a time, any other loop to a fixed point with widening),
templates at the arguments the file uses, `[&]` lambdas, aggregate
initialisers, inline asm outputs, warp intrinsics and the guards the
interval domain cannot prove alone (`__all_sync` on a bound, a guarded
subtraction). Held here:

  - every kernel entry of manifest.ABSINT_CUDA_FUNCS parses, proves with
    no finding and counts at least its floor of checked operations, and
    every function of its file that one of them calls is listed too;
  - each remaining wrap carries an `allow=` whose reason names the plain
    version's line, and each kernel contract names the guard of its entry;
  - for each construct, a fixture under tests/fixtures/tidy_torch/absint/
    that proves and one whose broken bound is a finding.
"""

import pathlib
import re

import pytest

from tigerbeetle_tpu_torch.tidy import absint, cparse, manifest

REPO = pathlib.Path(__file__).resolve().parents[1]
FIX = REPO / "tests" / "fixtures" / "tidy_torch" / "absint"
CSRC = "tigerbeetle_tpu_torch/csrc/"
KERNELS = ("create_transfers_exact.cu", "sharded_apply.cu",
           "create_transfers_fast.cu")

# Checked operations per listed function at this tree (adds, subtracts,
# multiplies, shifts, divisions, address offsets, conversions between
# integer types and callee range obligations): a drop means arithmetic
# left the proof. The helpers with none are listed so that the closure is
# read; each of them still parses in full.
FLOORS = {
    "create_transfers_exact.cu": {
        "is_zero": 0, "is_max": 0, "u64_of": 1, "rung": 0, "merge": 0,
        "clip": 1, "scatter_row": 2, "rec_slot": 3, "event_static": 39,
        "ld<uint4>": 0, "ld<uint32_t>": 0, "load_obs": 5, "base_obs": 12,
        "evaluate": 13, "shfl_up_u128": 1, "warp_sum_u128": 10,
        "ld_acquire": 0, "st_release": 0, "head_steps<5>": 16,
        "head_steps<3>": 10, "warp_seg_scan<5>": 52, "warp_seg_scan<3>": 32,
        "tile_scan<kRecLanes>": 38, "tile_scan<kEvLanes>": 14,
        "publish<kRecLanes>": 11, "publish<kEvLanes>": 7,
        "look_back<kRecLanes>": 145, "look_back<kEvLanes>": 69,
        "scan_tile<kRecLanes>": 25, "scan_tile<kEvLanes>": 13,
        "record_field": 3, "event_lanes": 4, "post_row": 3,
        "row_overflows": 4, "sync_sweep_blocks": 0, "copy_tables": 9,
        "exact_kernel": 228,
    },
    "sharded_apply.cu": {
        "local_row": 2, "row_overflows": 4, "post": 1, "load_pair<1>": 17,
        "load_pair<kMaxShards>": 17, "apply<1>": 83, "apply<kMaxShards>": 129,
    },
    "create_transfers_fast.cu": {
        "copy_check": 8, "ladder_post": 11, "touched_check": 15,
    },
}
# The functions with arithmetic of their own: each must check some.
NONZERO = (
    "clip", "scatter_row", "event_static", "evaluate", "shfl_up_u128",
    "warp_sum_u128", "head_steps<5>", "warp_seg_scan<5>",
    "tile_scan<kRecLanes>", "tile_scan<kEvLanes>", "publish<kRecLanes>",
    "publish<kEvLanes>", "look_back<kRecLanes>", "look_back<kEvLanes>",
    "scan_tile<kRecLanes>", "scan_tile<kEvLanes>", "record_field",
    "event_lanes", "post_row", "row_overflows", "copy_tables",
    "exact_kernel", "local_row", "post", "load_pair<kMaxShards>",
    "apply<kMaxShards>", "copy_check", "ladder_post", "touched_check",
)
ENTRIES = [(f, fn) for f, fns in FLOORS.items() for fn in fns]


def test_manifest_lists_every_kernel_entry_in_order():
    listed = [(rel[len(CSRC):], fn) for rel, fn in manifest.ABSINT_CUDA_FUNCS
              if rel[len(CSRC):] in KERNELS]
    assert listed == ENTRIES


@pytest.mark.parametrize("name,fn", ENTRIES, ids=[f"{f}::{fn}" for f, fn in ENTRIES])
def test_kernel_entry_proves_at_or_above_its_floor(name, fn):
    rel = CSRC + name
    fs, n = absint.prove_cuda_function(REPO / rel, rel, fn)
    assert fs == [], fs
    assert n >= FLOORS[name][fn], (fn, n)
    if fn in NONZERO:
        assert n > 0


def _spec(cf, spec, tenv=None):
    """(name, template argument values) of `name<args>` text."""
    name, args = absint._split_targs(spec)
    vals = []
    for a in args:
        v = int(a, 0) if a[:1].isdigit() else (tenv or {}).get(a)
        vals.append(v if v is not None else cf.const_targ(cparse.Name(a), tenv))
    return name, tuple(vals)


def _callees(body, cf, tenv):
    out = set()

    def walk(x):
        if isinstance(x, cparse.Call):
            f = x.fn
            name = f.n.split("::")[-1] if isinstance(
                f, (cparse.Name, cparse.TplName)) else None
            if name in cf.functions:
                args = tuple(cf.const_targ(a, tenv) for a in f.args) \
                    if isinstance(f, cparse.TplName) else None
                out.add((name, args))
        if isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif hasattr(x, "__dataclass_fields__"):
            for k in x.__dataclass_fields__:
                walk(getattr(x, k))

    walk(body)
    return out


@pytest.mark.parametrize("name", KERNELS)
def test_every_callee_of_a_listed_function_is_listed(name):
    """The proof of a caller assumes each callee's contract; the callee's
    own proof is a listed entry (of its file, or of a shared header)."""
    rel = CSRC + name
    cf = absint._cuda_file((REPO / rel).read_text(), rel, str(REPO / rel))
    listed = {_spec(cf, fn) for _r, fn in manifest.ABSINT_CUDA_FUNCS}
    bare = {n for n, _a in listed}
    for fn in FLOORS[name]:
        caller, targs = _spec(cf, fn)
        params = [p for _k, p in cf.functions[caller][0].tparams]
        for callee, args in _callees(cf.body(caller), cf, dict(zip(params, targs))):
            if args is None:  # arguments deduced from the call's types
                assert callee in bare, (fn, callee)
            else:
                assert (callee, args) in listed, (fn, callee, args)


@pytest.mark.parametrize("name", KERNELS)
def test_every_allow_names_the_plain_version_or_the_relation(name):
    src = (REPO / CSRC / name).read_text()
    allows = re.findall(r"tidy: allow=([\w|-]+)[^—\n]*— ([^\n]*)", src)
    assert allows or name == "create_transfers_fast.cu"
    for codes, reason in allows:
        assert set(codes.split("|")) <= {"limb-overflow", "limb-underflow"}
        assert "ops/commit_exact.py:" in reason or "relation" in reason, reason


@pytest.mark.parametrize("name,guard", [
    ("create_transfers_exact.cu", "a > 0x7FFFFFFF"),
    ("create_transfers_exact.cu", "max_sweeps > 0xFFFE"),
    ("create_transfers_exact.cu", "2 * n > 16384"),
    ("create_transfers_fast.cu", "a < 1 || a > 0x7FFFFFFF || n < 0 || n > 0x7FFFFFFF"),
    ("sharded_apply.cu", "args.shard[j].base < 0 || args.shard[j].base > 0x7FFFFFFF"),
    ("sharded_apply.cu", "args.n * args.count > (1ll << 30)"),
])
def test_kernel_contract_has_its_entry_guard(name, guard):
    """A kernel's `range=` is what its entry refuses to launch outside:
    the guard is in the entry, and refuses (never clamps)."""
    src = (REPO / CSRC / name).read_text()
    i = src.rindex(guard)
    assert "return (int)cudaErrorInvalidValue" in src[i:i + 200]


# --- one fixture that proves and one that does not, per construct ----------


@pytest.mark.parametrize("fixture,fn,expect", [
    ("unroll.cuh", "sum_steps<256>", []),
    ("unroll.cuh", "sum_steps<257>", [("limb-overflow", 14)]),
    ("unroll.cuh", "halving", []),
    ("wrap_add.cuh", "loops", []),
    ("widen.cuh", "count_to", []),
    ("widen.cuh", "count_past", [("limb-overflow", 21)]),
    ("asm_out.cuh", "reg32", []),
    ("asm_out.cuh", "reg64", [("limb-overflow", 19)]),
    ("lambda.cuh", "twice", []),
    ("lambda.cuh", "twice_high", [("limb-overflow", 22)]),
    ("vote.cuh", "warp_prefix<58>", []),
    ("vote.cuh", "warp_prefix<59>", [("limb-overflow", 18)]),
    ("guarded.cuh", "sub_guarded", []),
    ("guarded.cuh", "sub_flagged", []),
    ("guarded.cuh", "sub_unguarded", [("limb-underflow", 23)]),
    ("guarded.cuh", "sub_flag_stale", [("limb-underflow", 29)]),
    ("aggregate.cuh", "pair_small", []),
    ("aggregate.cuh", "pair_large", [("limb-overflow", 24)]),
])
def test_construct_fixture(fixture, fn, expect):
    fs, n = absint.prove_cuda_function(FIX / fixture, fixture, fn)
    assert [(f.code, f.line) for f in fs] == expect
    assert n > 0


def test_unrolled_loop_counts_each_iteration():
    """A constant-trip loop is read once per iteration: each of its adds
    is checked at that iteration's values."""
    n256 = absint.prove_cuda_function(FIX / "unroll.cuh", "unroll.cuh",
                                      "sum_steps<256>")[1]
    n3 = absint.prove_cuda_function(FIX / "unroll.cuh", "unroll.cuh",
                                    "halving")[1]
    assert n256 >= 256 and n3 == 5


def test_template_needs_an_argument_the_file_defines():
    fs, n = absint.prove_cuda_function(FIX / "unroll.cuh", "unroll.cuh",
                                       "sum_steps<kNoSuchConstant>")
    assert [f.code for f in fs] == ["c-parse"] and n == 0


def test_front_end_reads_the_kernels_constructs():
    """The parser's view of what the kernels use: a template header and
    __launch_bounds__ on the kernel, a lambda, an asm statement, a
    do-while and an aggregate initialiser."""
    rel = CSRC + "create_transfers_exact.cu"
    src = (REPO / rel).read_text()
    fns = {f.name: f for f in cparse.parse_functions(src)}
    assert fns["tile_scan"].tparams == (("int", "K"),)
    assert fns["ld"].tparams == (("type", "T"),)
    assert fns["exact_kernel"].launch_bounds == "kBlock"
    lanes = dict((f, d) for f, _t, d in cparse.struct_fields(src)["Lanes"])
    assert lanes == {"a": ("K",), "b": ("K",)}
    cf = absint._cuda_file(src, rel, str(REPO / rel))
    kinds = set()

    def walk(x):
        kinds.add(type(x).__name__)
        if isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif hasattr(x, "__dataclass_fields__"):
            for k in x.__dataclass_fields__:
                walk(getattr(x, k))

    for fn in ("exact_kernel", "ld_acquire", "look_back"):
        walk(cf.body(fn))
    assert {"Lambda", "SAsm", "SDo", "TplName", "SFor", "SWhile"} <= kinds
    walk(cf.body("exact_kernel"))
    rel2 = CSRC + "sharded_apply.cu"
    cf2 = absint._cuda_file((REPO / rel2).read_text(), rel2, str(REPO / rel2))
    kinds.clear()
    walk(cf2.body("apply"))
    assert {"Compound", "Lambda"} <= kinds
