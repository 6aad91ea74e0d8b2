"""What the port's static passes analyze: the scopes of every pass over
this package (tigerbeetle_tpu_torch/), its tests and its scripts.

The pipeline runs four thread roles, as the reference package's does:

  - `loop`   — the asyncio event loop (or the simulator/test main
               thread standing in for it): all VSR protocol state.
  - `wal`    — the WalWriter thread (vsr/journal.py): durable WAL
               writes.
  - `commit` — the commit-execution context: the CommitExecutor thread
               when the overlapped stage is attached, the event loop
               itself on the serial fallback. State-machine execution
               and its kernel launches live here.
  - `store`  — the StoreExecutor thread: deferred groove/index writes,
               compaction beats and their kernel launches.

The commit thread, the store thread and the loop all launch kernels on
the card's default stream: the launch counters of ops/kernels.py are
shared by all three, and a hidden device-to-host sync on any of them
serializes the split-phase window (the host-sync pass guards that).

A class is analyzed when it appears here or carries any `# tidy:`
annotation. Method→role resolution order: `thread=` annotation on the
def, a `threading.Thread(target=self._x, name=...)` construction (the
name maps through THREAD_NAME_ROLES), intra-class call-graph
propagation from resolved methods, and finally the class's default
role. Cross-class call edges are not traced: the role of a public
entry point is a declaration.
"""

from __future__ import annotations

# The package every pass is rooted in (ownership walks all of it).
PACKAGE = "tigerbeetle_tpu_torch"

# The role vocabulary (tidy/runtime.py's stamps use the same names).
ROLES = frozenset(("loop", "wal", "commit", "store", "any"))

# threading.Thread(name=...) literal -> role of its target method.
THREAD_NAME_ROLES = {
    "wal-writer": "wal",
    "commit-executor": "commit",
    "store-executor": "store",
}

# Barrier callables (names) accepted by `barrier=` annotations: a
# cross-thread access ordered by one of these is sequenced, not racing.
BARRIERS = frozenset(("store_barrier", "drain", "wait", "quiesce", "join"))

# (repo-relative file, class) -> default role set ("|"-joined) for
# methods the resolution steps above leave unassigned. A multi-role
# default (DurableIndex, Grid) says the object is shared between the
# commit and store contexts wholesale: its attributes then need explicit
# declarations.
OWNERSHIP_CLASSES = {
    ("tigerbeetle_tpu_torch/vsr/pipeline.py", "CommitExecutor"): "loop",
    ("tigerbeetle_tpu_torch/vsr/pipeline.py", "StoreExecutor"): "loop",
    ("tigerbeetle_tpu_torch/vsr/journal.py", "WalWriter"): "loop",
    ("tigerbeetle_tpu_torch/lsm/tree.py", "DurableIndex"): "commit|store",
    ("tigerbeetle_tpu_torch/models/state_machine.py", "StateMachine"): "commit",
    ("tigerbeetle_tpu_torch/io/grid.py", "Grid"): "commit|store",
    ("tigerbeetle_tpu_torch/net/bus.py", "_Conn"): "loop",
    ("tigerbeetle_tpu_torch/net/bus.py", "ReplicaServer"): "loop",
}

# Modules whose top-level mutable globals are ownership-checked the same
# way (functions stand in for methods; `with <lockname>:` scopes count).
# value = default role for the module's functions. ops/kernels.py: the
# loaded libraries (`_libs`, `_loaded`) and the launch counts
# (`LAUNCHES`) are shared by the commit and store threads and the loop,
# which all launch kernels.
OWNERSHIP_MODULES = {
    "tigerbeetle_tpu_torch/tracer.py": "any",
    "tigerbeetle_tpu_torch/devicestats.py": "any",
    "tigerbeetle_tpu_torch/ops/kernels.py": "any",
}

# --- determinism lint scope ---------------------------------------------

# The deterministic core: every replica must be a pure function of
# (state, ordered batch). vsr/clock.py is the one sanctioned wall-clock
# reader (Marzullo-synchronized timestamps enter state only through the
# primary's prepare headers, which the batch carries).
DETERMINISM_INCLUDE = (
    "tigerbeetle_tpu_torch/models",
    "tigerbeetle_tpu_torch/lsm",
    "tigerbeetle_tpu_torch/vsr",
    "tigerbeetle_tpu_torch/ops",
)
DETERMINISM_EXCLUDE = ("tigerbeetle_tpu_torch/vsr/clock.py",)

# --- host-sync / reduction: the split-phase window's hot set -----------

# Modules the host-sync and reduction passes analyze: the kernel
# wrappers and their plain versions (ops/, parallel/), the host
# dispatcher that calls them (models/state_machine.py) and the tracer
# whose dispatch windows bracket every launch. Every function here is
# hot unless it is a seam or listed in SYNCLINT_HOST_ONLY.
SYNCLINT_MODULES = (
    "tigerbeetle_tpu_torch/ops/commit.py",
    "tigerbeetle_tpu_torch/ops/commit_exact.py",
    "tigerbeetle_tpu_torch/ops/kernels.py",
    "tigerbeetle_tpu_torch/ops/merge.py",
    "tigerbeetle_tpu_torch/ops/qindex.py",
    "tigerbeetle_tpu_torch/ops/scanops.py",
    "tigerbeetle_tpu_torch/ops/u128.py",
    "tigerbeetle_tpu_torch/models/state_machine.py",
    "tigerbeetle_tpu_torch/parallel/sharding.py",
    "tigerbeetle_tpu_torch/parallel/sharded_ops.py",
    "tigerbeetle_tpu_torch/tracer.py",
    # note_call runs next to every launch; cost_table and device_status
    # answer /device on the event loop: neither may wait on the card.
    "tigerbeetle_tpu_torch/devicestats.py",
)

# The kernel entries, by wrapper name (callable tail name). The host-sync
# pass reads them as the calls whose results are tensors on the card
# (materializing one off the seam is a sync); the tracer admits exactly
# these names to its device windows (tracer.device_step /
# device_dispatch), and on a mesh the state machine names them
# MESH_ENTRY_PREFIX + entry.
KERNEL_ENTRIES = frozenset((
    "create_transfers_fast", "create_transfers_exact", "exact_sort_plan",
    "register_accounts", "register_accounts_sharded", "write_balances",
    "write_balances_sharded", "read_balances", "merge_kernel",
    "merge_kernel_tiled", "compact_fold_kernel", "query_index_keys",
    "query_index_keys_sorted", "scan_intersect_mask", "sharded_apply",
    "sharded_apply_grouped", "sharded_validate", "sharded_validate_grouped",
    "sharded_read", "sharded_read_grouped",
))
MESH_ENTRY_PREFIX = "sharded."

# (repo-relative file, qualified function) pairs forming the sanctioned
# dispatch/finish seam: the only places of the hot set allowed to wait on
# the card. These map the reference's JAXLINT_SYNC_SEAM onto the port,
# each at the function that holds the port's sync.
SYNCLINT_SEAM = frozenset((
    # The fast route's one sync: the codes of a batch come back after its
    # launch (the serial route, and the bail check, read them here).
    ("tigerbeetle_tpu_torch/models/state_machine.py", "StateMachine._commit_fast_device"),
    # The split-phase window's finish: the codes of a dispatched batch.
    ("tigerbeetle_tpu_torch/models/state_machine.py", "StateMachine.create_transfers_finish"),
    # The exact route syncs on its bail flag, then reads codes and
    # amounts back (and the balances of the history rows, where kept).
    ("tigerbeetle_tpu_torch/models/state_machine.py", "StateMachine._create_transfers_exact"),
    # One Event.synchronize() on the read's pinned block.
    ("tigerbeetle_tpu_torch/models/state_machine.py", "StateMachine._read_balances"),
    # The device query-index pipeline's sync points: a lazy run's
    # materialization waits on its build's event (under the run's lock).
    ("tigerbeetle_tpu_torch/ops/qindex.py", "QueryKeyRun._materialize_locked"),
    # The streaming compaction's only sync point: the back half of the
    # split-phase double buffer.
    ("tigerbeetle_tpu_torch/ops/merge.py", "compact_fold_materialize"),
    # The copy back of a sorted run's keys and payloads. Its callers are
    # the seams of the reference's list: a lazy run's materialization,
    # the device fold's table build (qindex.materialize_fold), the
    # compaction fold's back half and a general merge on the card
    # (merge.merge_device).
    ("tigerbeetle_tpu_torch/ops/merge.py", "to_host_kv"),
    # The device scan-intersect's only sync point, on the query path.
    ("tigerbeetle_tpu_torch/ops/scanops.py", "finish_intersect"),
    # Closes a dispatch window with the card's time: runs only with the
    # tracer on, and only from the seams above, after their own sync.
    ("tigerbeetle_tpu_torch/tracer.py", "device_finish"),
))

# Functions of SYNCLINT_MODULES that are not on the card's path, each
# with its reason: a sync there waits on nothing the window runs.
SYNCLINT_HOST_ONLY = {
    ("tigerbeetle_tpu_torch/ops/commit_exact.py", "create_transfers_exact_plain"):
        "the exact kernel's plain version: the wrapper calls it only for "
        "tensors on the CPU, where .item() waits on no device",
    ("tigerbeetle_tpu_torch/ops/commit.py", "state_to_numpy"):
        "a read-back of the whole balance table for comparisons "
        "(chip_smoke.py, the tests); no commit path calls it",
    ("tigerbeetle_tpu_torch/parallel/sharding.py", "sharded_state_to_numpy"):
        "the mesh's read-back of every shard for comparisons "
        "(chip_smoke.py, the tests); no commit path calls it",
}

# --- nativecheck: C-boundary analysis scope ------------------------------

# The shared top-level C sources (csrc/) the port builds with gcc into
# its own build directory (native/__init__.py). Every C-family file
# under csrc/ is scanned or excluded here with its reason.
NATIVE_C_SOURCES = (
    "csrc/busio.c",
    "csrc/hostops.c",
    "csrc/aegis128l.c",
    "csrc/tb_client.c",
    "csrc/tb_client.h",
)
NATIVE_C_EXCLUDE = {
    "csrc/cpp_sample.cpp":
        "C++17 embedder sample (templates/RAII outside cparse's C "
        "subset); exposes no ctypes surface",
    "csrc/tb_client.hpp":
        "header-only C++ wrapper over tb_client.h; the C ABI underneath "
        "is the scanned contract (tb_client.h)",
}

# The port's ctypes bindings of the C sources above.
NATIVE_PY_BINDINGS = "tigerbeetle_tpu_torch/native/__init__.py"

# The CUDA kernels: their sources, and the ctypes bindings of their
# `extern "C"` entries (ops/kernels.py SIGNATURES and helper() calls).
# Only the `extern "C"` declarations of a .cu file are read; every .cu
# file here is checked, and one whose entries cannot be read is a
# finding.
NATIVE_CU_DIR = "tigerbeetle_tpu_torch/csrc"
NATIVE_CU_BINDINGS = "tigerbeetle_tpu_torch/ops/kernels.py"
# Modules whose `kernels.helper(name, symbol, argtypes, restype)` calls
# bind host-side helpers of a kernel's library.
NATIVE_CU_HELPER_CALLERS = (
    "tigerbeetle_tpu_torch/ops/commit_exact.py",
    "tigerbeetle_tpu_torch/ops/merge.py",
)

# (repo-relative C file, function) pairs the C bounds-absint interprets.
# Each carries a `/* tidy: range=/bound= */` entry annotation in source;
# a listed function that fails to parse or goes missing is a finding.
NATIVE_ABSINT_FUNCS = (
    ("csrc/busio.c", "busio_scan"),
    ("csrc/hostops.c", "gallop_lower_u32"),
    ("csrc/hostops.c", "hostops_intersect_u32"),
    ("csrc/hostops.c", "hostops_gallop_mark_u32"),
    ("csrc/hostops.c", "hostops_merge_kv_bloom"),
)

# --- absint: the interval proof of the limb arithmetic --------------------

# Python targets and the mode each is read in (tidy/absint.py says why):
# the plain u128 on its signed int64 carrier, the fold56 key build on
# numpy uint64 words, and the device key build's int64-carried uint32
# words, which must stay 32-bit words.
ABSINT_TARGETS = {
    "tigerbeetle_tpu_torch/ops/u128.py": "i64",
    "tigerbeetle_tpu_torch/lsm/scan.py": "u64",
    "tigerbeetle_tpu_torch/ops/qindex.py": "u32",
}

# The device code that carries the port's u128 and fold56 arithmetic,
# (repo-relative CUDA source, function), proven by absint's CUDA front
# end: the shared helpers, then the commit kernels whole, with every
# helper they call (`name<args>` is a template at those arguments). A
# listed function that goes missing or leaves the subset is a finding.
ABSINT_CUDA_FUNCS = (
    ("tigerbeetle_tpu_torch/csrc/common.cuh", "sum_overflows"),
    ("tigerbeetle_tpu_torch/csrc/common.cuh", "atomic_add_u128"),
    ("tigerbeetle_tpu_torch/csrc/common.cuh", "atomic_sub_u128"),
    ("tigerbeetle_tpu_torch/csrc/common.cuh", "to_u128"),
    ("tigerbeetle_tpu_torch/csrc/common.cuh", "from_u128"),
    ("tigerbeetle_tpu_torch/csrc/common.cuh", "add3"),
    ("tigerbeetle_tpu_torch/csrc/common.cuh", "wide_gt"),
    ("tigerbeetle_tpu_torch/csrc/qindex_fold.cuh", "tag_of"),
    ("tigerbeetle_tpu_torch/csrc/qindex_fold.cuh", "fold56_u64"),
    ("tigerbeetle_tpu_torch/csrc/qindex_fold.cuh", "fold56_u128"),
    ("tigerbeetle_tpu_torch/csrc/qindex_fold.cuh", "block_key"),
    ("tigerbeetle_tpu_torch/csrc/ladder.cuh", "is_zero"),
    ("tigerbeetle_tpu_torch/csrc/ladder.cuh", "is_max"),
    ("tigerbeetle_tpu_torch/csrc/ladder.cuh", "ladder"),
    ("tigerbeetle_tpu_torch/csrc/ladder.cuh", "posts"),
) + tuple(
    ("tigerbeetle_tpu_torch/csrc/create_transfers_exact.cu", f) for f in (
        # the event ladders and their helpers
        "is_zero", "is_max", "u64_of", "rung", "merge", "clip",
        "scatter_row", "rec_slot", "event_static", "ld<uint4>",
        "ld<uint32_t>", "load_obs", "base_obs", "evaluate",
        # the sweeps' segmented scans, at both lane counts
        "shfl_up_u128", "warp_sum_u128", "ld_acquire", "st_release",
        "head_steps<5>", "head_steps<3>", "warp_seg_scan<5>",
        "warp_seg_scan<3>",
        "tile_scan<kRecLanes>", "tile_scan<kEvLanes>",
        "publish<kRecLanes>", "publish<kEvLanes>",
        "look_back<kRecLanes>", "look_back<kEvLanes>",
        "scan_tile<kRecLanes>", "scan_tile<kEvLanes>",
        # the records, the posting and the kernel
        "record_field", "event_lanes", "post_row", "row_overflows",
        "sync_sweep_blocks", "copy_tables", "exact_kernel",
    )
) + tuple(
    ("tigerbeetle_tpu_torch/csrc/sharded_apply.cu", f) for f in (
        "local_row", "row_overflows", "post", "load_pair<1>",
        "load_pair<kMaxShards>", "apply<1>", "apply<kMaxShards>",
    )
) + tuple(
    ("tigerbeetle_tpu_torch/csrc/create_transfers_fast.cu", f) for f in (
        "copy_check", "ladder_post", "touched_check",
    )
)

# Directories the pointer-lifetime lint walks for `.ctypes.data` captures.
NATIVE_LIFETIME_SCAN_DIRS = ("tigerbeetle_tpu_torch",)

# --- vsrlint: VSR protocol lint scope ------------------------------------

# Modules the protocol lints analyze: the replica state machine, the WAL
# journal, the durable superblock and the wire ingress.
VSRLINT_MODULES = (
    "tigerbeetle_tpu_torch/vsr/replica.py",
    "tigerbeetle_tpu_torch/vsr/journal.py",
    "tigerbeetle_tpu_torch/vsr/superblock.py",
    "tigerbeetle_tpu_torch/net/bus.py",
)

# Where the Command enum and the replica dispatch table live.
VSRLINT_COMMAND_MODULE = "tigerbeetle_tpu_torch/vsr/header.py"
VSRLINT_DISPATCH = ("tigerbeetle_tpu_torch/vsr/replica.py", "on_message")

# Command members that deliberately have no replica dispatch handler,
# each with the place it is handled.
VSRLINT_COMMAND_EXEMPT = {
    "RESERVED":
        "command 0 is the invalid-frame sentinel — the codec and "
        "Header.verify reject it before dispatch, it never reaches "
        "on_message",
    "PING_CLIENT":
        "answered at the bus ingress (net/bus.py ReplicaServer pre-"
        "dispatch fast path) — client pings never reach the replica "
        "state machine",
    "PONG_CLIENT":
        "client-bound: emitted by ReplicaServer in answer to "
        "PING_CLIENT, consumed by client.py — a replica never receives "
        "one",
    "REPLY":
        "client-bound: produced by the commit path, consumed by "
        "client.py and the testing SimClient — replicas route it "
        "outward, never inward",
    "EVICTION":
        "client-bound session eviction, consumed by client.py / "
        "SimClient",
    "BUSY":
        "client-bound admission shed, consumed by client.py / "
        "SimClient",
}

# Inbound header fields the wire-taint rule treats as attacker-tainted
# until they pass a validation guard inside the handler.
VSRLINT_WIRE_FIELDS = frozenset((
    "view", "op", "commit", "commit_min", "commit_max", "op_checkpoint",
    "checksum", "parent", "client", "request", "replica", "timestamp",
    "operation", "context", "size", "session", "epoch",
))

# Replica/journal/superblock attributes that constitute protocol state.
VSRLINT_STATE_FIELDS = frozenset((
    "view", "log_view", "op", "commit_min", "commit_max", "status",
    "op_checkpoint", "checksum_floor", "timestamp_max", "view_durable",
))

# Fields whose assignments must be proven non-decreasing or carry a
# `# tidy: monotonic=<field> — reason` annotation.
VSRLINT_MONOTONIC_FIELDS = frozenset((
    "view", "log_view", "op", "commit_min", "commit_max",
    "op_checkpoint", "checksum_floor", "timestamp_max", "sequence",
    "config_epoch",
))

# Functions that establish state rather than advance it (constructors,
# the formatter, the boot path's reload from durable storage).
VSRLINT_MONOTONIC_INIT_FUNCS = frozenset(
    ("__init__", "format", "open", "recover")
)

# Cluster sizes the quorum-arithmetic pass evaluates (reference
# constants.zig replicas_max) and the standby counts.
VSRLINT_QUORUM_REPLICA_RANGE = (1, 6)
VSRLINT_QUORUM_STANDBY_RANGE = (0, 6)

# --- marker scan scope ---------------------------------------------------

# The port's files: its package, its tests and test helpers, its smoke
# script and its tools. Fixture files deliberately hold violations.
MARKER_SCAN_DIRS = ("tigerbeetle_tpu_torch",)
MARKER_SCAN_GLOBS = ("tests/test_torch_*.py", "tools/torch_*.py")
MARKER_SCAN_FILES = (
    "chip_smoke.py",
    "tests/frontdoor_servers.py",
    "tests/cluster_scenarios.py",
    "tests/intersect_cases.py",
    "tests/fold_stacks.py",
    "tests/exact_batches.py",
)
MARKER_SCAN_EXCLUDE_DIRS = ("tests/fixtures",)

# Stub markers and debug leftovers (the reference tidy.zig banned-word
# family). Spelled split so this file never matches its own scan.
BANNED_MARKERS = (
    "NotImplemented" + "Error",
    "TO" + "DO",
    "FIX" + "ME",
    "X" + "XX",
    "breakpoint" + "(",
    "import" + " pdb",
)

# The module-docstring requirement applies to the package only.
DOCSTRING_SCAN_DIRS = ("tigerbeetle_tpu_torch",)
