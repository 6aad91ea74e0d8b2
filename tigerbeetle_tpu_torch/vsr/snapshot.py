"""Pickle-free checkpoint snapshots with fixed structured dtypes.

The checkpoint blob is this build's stand-in for upstream's
checkpoint trailer (upstream src/vsr/checkpoint_trailer.zig), which
chunks free-set / client-session state into typed grid blocks. Every
section here is a fixed structured numpy dtype serialized with np.savez and
read back with ``allow_pickle=False`` — a peer-supplied snapshot body can
never execute code (it previously could: object-dtype arrays forced
``allow_pickle=True`` on load, i.e. remote code execution for any peer that
could pass the body checksum).

Sections:
  accounts   — immutable per-account fields + exact u128 balances (lo/hi u64)
  transfers  — wire-layout TRANSFER_DTYPE rows, commit order
  posted     — pending-transfer fulfillment map (timestamp → u8)
  history    — HISTORY_DTYPE rows (reference AccountHistoryGrooveValue,
               state_machine.zig:275-292), u128 balances as u64 pairs
  clients    — CLIENT_ENTRY_DTYPE rows + concatenated sealed reply messages
               (reference client_sessions.zig replicated client table)
"""

from __future__ import annotations

import io as _io
from typing import Dict, List, Tuple

import numpy as np

U64_MAX = (1 << 64) - 1

# One AccountHistoryGrooveValue row; u128 values as (lo, hi) u64 pairs.
# (The durable history groove stores exactly this layout on disk.)
from tigerbeetle_tpu_torch.lsm.groove import HISTORY_DTYPE  # noqa: E402

CLIENT_ENTRY_DTYPE = np.dtype(
    [
        ("client_lo", "<u8"), ("client_hi", "<u8"),
        ("session", "<u8"),
        # Op of the session's last committed request: the replicated LRU
        # key — install() rebuilds the client dict sorted by it, so the
        # eviction order survives checkpoint round-trips byte-identically
        # on every replica (rows themselves stay sorted by client id).
        ("last_op", "<u8"),
        ("request", "<u4"),
        ("reply_len", "<u4"),
    ]
)

# (slot, epoch at which it was last reassigned by a committed
# RECONFIGURE) — the per-slot quorum fence (replica.slot_epoch).
SLOT_EPOCH_DTYPE = np.dtype([("slot", "<u4"), ("_pad", "<u4"), ("epoch", "<u8")])

# (index, payload checksum) of every content block the checkpoint
# references — the identity list block-level state sync verifies against
# (reference: block references carry checksums; grid_blocks_missing.zig).
BLOCK_CKS_DTYPE = np.dtype(
    [("block", "<u4"), ("_pad", "<u4"), ("cks_lo", "<u8"), ("cks_hi", "<u8")]
)


def _split(v: int) -> Tuple[int, int]:
    return v & U64_MAX, v >> 64


def _join(lo, hi) -> int:
    return int(lo) | (int(hi) << 64)


def history_to_array(history) -> np.ndarray:
    out = np.zeros(len(history), dtype=HISTORY_DTYPE)
    for i, r in enumerate(history):
        rec = out[i]
        rec["timestamp"] = r.timestamp
        for side in ("dr", "cr"):
            for field in (
                "account_id",
                "debits_pending", "debits_posted",
                "credits_pending", "credits_posted",
            ):
                lo, hi = _split(getattr(r, f"{side}_{field}"))
                rec[f"{side}_{field}_lo"] = lo
                rec[f"{side}_{field}_hi"] = hi
    return out


def history_from_array(arr: np.ndarray) -> List:
    from tigerbeetle_tpu_torch.models.oracle import HistoryRow

    out = []
    for rec in arr:
        row = HistoryRow(timestamp=int(rec["timestamp"]))
        for side in ("dr", "cr"):
            for field in (
                "account_id",
                "debits_pending", "debits_posted",
                "credits_pending", "credits_posted",
            ):
                setattr(
                    row, f"{side}_{field}",
                    _join(rec[f"{side}_{field}_lo"], rec[f"{side}_{field}_hi"]),
                )
        out.append(row)
    return out


def content_trees(sm):
    """(prefix, DurableIndex) for every LSM tree the checkpoint persists."""
    return (
        ("ti", sm.transfer_index),
        ("ai", sm.account_rows),
        ("qi", sm.query_rows),
        ("po", sm.posted.index),
        ("hi", sm.history.rows),
    )


def content_logs(sm):
    """(prefix, DurableLog) for every object log the checkpoint persists."""
    return (("log", sm.transfer_log), ("hlog", sm.history.log))


def referenced_blocks(sm, tree_fences) -> np.ndarray:
    """Every CONTENT grid block the checkpoint references: object-log
    blocks, each LSM table's index block + data blocks (from
    `tree_fences`, the fence arrays encode() already computed per tree),
    and each in-flight compaction job's block RESERVATION (the job
    descriptor references those blocks; their content is rebuilt by the
    restarted job, so they are allocated but not checksummed).
    The encoded free set is derived from THIS — references-exact by
    construction, so it is byte-deterministic across replicas regardless
    of allocation history. The checkpoint trailer's own blocks are
    deliberately EXCLUDED (their placement is per-replica); restore paths
    re-mark them allocated from the superblock's trailer reference."""
    free = np.ones(sm.grid.block_count, dtype=bool)
    blocks = []
    for _name, log in content_logs(sm):
        blocks.extend(log.blocks)
    for (_name, tree), fences in zip(content_trees(sm), tree_fences):
        for level in tree.levels:
            for t in level:
                blocks.append(t.index_block)
        blocks.extend(fences["block"].tolist())
        st = tree.job_state()
        if st is not None:
            blocks.extend(st[3])  # the reservation block list
    if blocks:
        free[np.array(blocks, dtype=np.int64)] = False
    return free


def _slot_epochs_array(replica) -> np.ndarray:
    rows = np.zeros(len(replica.slot_epoch), dtype=SLOT_EPOCH_DTYPE)
    for i, (slot, epoch) in enumerate(sorted(replica.slot_epoch.items())):
        rows[i]["slot"] = slot
        rows[i]["epoch"] = epoch
    return rows


def encode(replica) -> bytes:
    """Serialize the replica's replicated state at its current commit
    point. Transfers stay in the grid; the blob carries the account
    columns + balances, LSM manifests + fences, the log's block list +
    tail, the referenced-block checksum list, and the EWAH free set —
    O(accounts + tables), never O(history). The SAME blob serves local
    recovery and state sync: a peer installs the RAM state and fetches
    whichever referenced blocks its own grid is missing (block-level
    sync, reference replica.zig:2289,2413). Every section is
    byte-deterministic across replicas (the storage checker compares all
    of them except per-replica client reply seals).
    """
    sm = replica.state_machine
    # A deferred (or async-queued) store must never miss a checkpoint.
    sm.store_barrier()
    count = sm.account_count
    dp, dpo, cp, cpo = sm._read_balances(np.arange(count, dtype=np.int64))

    client_rows = np.zeros(len(replica.clients), dtype=CLIENT_ENTRY_DTYPE)
    reply_blobs: List[bytes] = []
    for i, (cid, sess) in enumerate(sorted(replica.clients.items())):
        raw = sess.reply.to_bytes() if sess.reply is not None else b""
        client_rows[i]["client_lo"], client_rows[i]["client_hi"] = _split(cid)
        client_rows[i]["session"] = sess.session
        client_rows[i]["last_op"] = sess.last_op
        client_rows[i]["request"] = sess.request
        client_rows[i]["reply_len"] = len(raw)
        reply_blobs.append(raw)

    sections = dict(
        # v7: per-tree storm-request flags (queued-but-unplanned major
        # compactions; a PLANNED storm persists through the job
        # descriptor's sentinel level). v6: client_table gains last_op
        # (front-door LRU eviction order). v5:
        # config_epoch/slot_epochs, qi query tree, per-tree
        # compaction-job descriptors. No migration path between versions
        # — data files are not carried across builds; the bump is
        # diagnostic.
        version=np.uint32(7),
        account_count=np.int64(count),
        acc_key_hi=sm.acc_key["hi"][:count], acc_key_lo=sm.acc_key["lo"][:count],
        acc_ud128_lo=sm.acc_user_data_128_lo[:count],
        acc_ud128_hi=sm.acc_user_data_128_hi[:count],
        acc_ud64=sm.acc_user_data_64[:count], acc_ud32=sm.acc_user_data_32[:count],
        acc_ledger=sm.acc_ledger[:count], acc_code=sm.acc_code[:count],
        acc_flags=sm.acc_flags[:count], acc_ts=sm.acc_timestamp[:count],
        bal_dp=dp, bal_dpo=dpo, bal_cp=cp, bal_cpo=cpo,
        prepare_timestamp=np.uint64(replica.committed_timestamp_max),
        commit_timestamp=np.uint64(sm.commit_timestamp),
        # Count of committed RECONFIGUREs at this checkpoint + per-slot
        # reassignment epochs: state sync must install them (a synced
        # replica never replays the ops that bumped them). Deterministic
        # across replicas, so the storage checker's byte-comparison holds.
        config_epoch=np.uint64(replica.config_epoch),
        slot_epochs=_slot_epochs_array(replica),
        client_table=client_rows,
        client_replies=np.frombuffer(b"".join(reply_blobs), dtype=np.uint8),
    )
    # Posted + history live in durable grooves: the blob
    # carries manifests + fences + log block lists — O(tables), no
    # whole-state re-encode per checkpoint.
    ref: List[int] = []
    tree_fences = []
    for name, log in content_logs(sm):
        blocks, tail = log.checkpoint()
        sections[f"{name}_blocks"] = blocks
        sections[f"{name}_tail"] = tail
        ref.extend(int(b) for b in blocks)
    for name, tree in content_trees(sm):
        sections[f"{name}_manifest"] = tree.checkpoint()
        fences, counts = tree.checkpoint_fences()
        sections[f"{name}_fences"] = fences
        sections[f"{name}_fence_counts"] = counts
        tree_fences.append(fences)
        # In-flight compaction job descriptor (jobs span checkpoints;
        # see DurableIndex.checkpoint): (level, n_inputs, progress) +
        # reservation.
        st = tree.job_state()
        sections[f"{name}_job"] = (
            np.array([st[0], st[1], st[2]], dtype=np.uint64)
            if st is not None else np.zeros(0, dtype=np.uint64)
        )
        sections[f"{name}_job_resv"] = np.array(
            st[3] if st is not None else [], dtype=np.uint32
        )
        # A storm queued but not yet planned as a job (request_major →
        # first-beat window): the flag must survive the checkpoint or a
        # restarted replica would silently drop the forced major.
        sections[f"{name}_storm"] = np.array(
            [tree.storm_state()], dtype=np.uint64
        )
        ref.extend(
            t.index_block for level in tree.levels for t in level
        )
        ref.extend(fences["block"].tolist())
    # Identity of every referenced content block, for block-level sync.
    cks_rows = np.zeros(len(ref), dtype=BLOCK_CKS_DTYPE)
    for i, b in enumerate(ref):
        c = sm.grid.block_cks.get(b)
        if c is None:
            # Not in the RAM map (block restored before checksum tracking
            # or map evicted): read it back from the grid once.
            c = sm.grid.local_checksum(b)
            assert c is not None, f"referenced block {b} unreadable at checkpoint"
            sm.grid.block_cks[b] = c
        cks_rows[i]["block"] = b
        cks_rows[i]["cks_lo"] = c & U64_MAX
        cks_rows[i]["cks_hi"] = c >> 64
    sections["block_cks"] = cks_rows
    from tigerbeetle_tpu_torch.io import ewah

    sections["free_set"] = np.frombuffer(
        ewah.encode(ewah.bitset_to_words(
            referenced_blocks(sm, tree_fences)
        )),
        dtype=np.uint8,
    )

    buf = _io.BytesIO()
    np.savez(buf, **sections)
    return buf.getvalue()


def block_checksums(blob: bytes) -> dict:
    """{block index: payload checksum} for every content block the blob
    references (the receiver side of block-level sync verifies its local
    grid against this and fetches only mismatches)."""
    z = np.load(_io.BytesIO(blob), allow_pickle=False)
    rows = z["block_cks"]
    return {
        int(r["block"]): int(r["cks_lo"]) | (int(r["cks_hi"]) << 64)
        for r in rows
    }


_TREE_PREFIXES = ("ti", "ai", "qi", "po", "hi")
_LOG_PREFIXES = ("log", "hlog")

_LOCAL_REQUIRED = (
    "account_count", "acc_key_hi", "acc_key_lo",
    "acc_ud128_lo", "acc_ud128_hi", "acc_ud64", "acc_ud32",
    "acc_ledger", "acc_code", "acc_flags", "acc_ts",
    "bal_dp", "bal_dpo", "bal_cp", "bal_cpo",
    "prepare_timestamp", "commit_timestamp", "config_epoch",
    "slot_epochs", "client_table", "client_replies",
    *(f"{p}_{s}" for p in _TREE_PREFIXES
      for s in ("manifest", "fences", "fence_counts", "job", "job_resv")),
    *(f"{p}_{s}" for p in _LOG_PREFIXES for s in ("blocks", "tail")),
    "block_cks", "free_set",
)


def validate(blob: bytes) -> bool:
    """Parse-check a checkpoint blob BEFORE destructive install: np.load
    with pickle disabled, every section install() reads present, shapes
    coherent. Defense in depth — install() is additionally wrapped in a
    rollback — but a blob passing here should not make install() raise."""
    try:
        z = np.load(_io.BytesIO(blob), allow_pickle=False)
        for k in _LOCAL_REQUIRED:
            _ = z[k]
        count = int(z["account_count"])
        if count < 0:
            return False
        for k in _LOCAL_REQUIRED[1:11]:
            if z[k].shape != (count,):
                return False
        for k in ("bal_dp", "bal_dpo", "bal_cp", "bal_cpo"):
            if z[k].shape != (count, 4):
                return False
        if z["client_table"].dtype != CLIENT_ENTRY_DTYPE:
            return False
        if int(z["client_table"]["reply_len"].sum()) != len(z["client_replies"]):
            return False
        if z["block_cks"].dtype != BLOCK_CKS_DTYPE:
            return False
        for p in _TREE_PREFIXES:
            if int(z[f"{p}_fence_counts"].sum()) != len(z[f"{p}_fences"]):
                return False
        if z["hlog_tail"].dtype != HISTORY_DTYPE:
            return False
        return True
    except Exception:
        return False


def free_set_bytes(blob: bytes) -> bytes | None:
    """The EWAH free-set section of a checkpoint blob."""
    try:
        z = np.load(_io.BytesIO(blob), allow_pickle=False)
        if "free_set" not in z:
            return None
        return z["free_set"].tobytes()
    except Exception:
        return None


def rebuild_transfer_bloom(sm) -> None:
    """Rebuild the transfer-id Bloom pre-filter (RAM-only; no false
    negatives allowed: every stored id must be re-added) by scanning the
    restored object log. Requires every log block to be present."""
    for _base, recs in sm.transfer_log.scan_range(0, sm.transfer_log.count):
        sm.transfer_seen.add(recs["id_lo"], recs["id_hi"])


def install(replica, blob: bytes, rebuild_bloom: bool = True,
            block_cks_map: dict | None = None) -> None:
    """Install a snapshot into a freshly reset replica state machine.

    Strictly ``allow_pickle=False``: a malformed blob raises (the caller
    treats that as a failed sync / corrupt checkpoint), it never executes.

    rebuild_bloom=False defers the transfer-id Bloom rebuild (it scans the
    object log's grid blocks, which a block-level sync receiver does not
    hold yet) — the caller runs rebuild_bloom() once the blocks arrive.
    block_cks_map: pre-parsed block_checksums(blob), when the caller
    already computed it (avoids re-parsing the multi-MB blob).
    """
    from tigerbeetle_tpu_torch.lsm.store import pack_keys
    from tigerbeetle_tpu_torch.vsr.header import Message
    from tigerbeetle_tpu_torch.vsr.replica import ClientSession

    z = np.load(_io.BytesIO(blob), allow_pickle=False)
    sm = replica.state_machine
    count = int(z["account_count"])
    sm.account_count = count
    keys = pack_keys(z["acc_key_lo"], z["acc_key_hi"])
    sm.acc_key[:count] = keys
    sm.acc_user_data_128_lo[:count] = z["acc_ud128_lo"]
    sm.acc_user_data_128_hi[:count] = z["acc_ud128_hi"]
    sm.acc_user_data_64[:count] = z["acc_ud64"]
    sm.acc_user_data_32[:count] = z["acc_ud32"]
    sm.acc_ledger[:count] = z["acc_ledger"]
    sm.acc_code[:count] = z["acc_code"]
    sm.acc_flags[:count] = z["acc_flags"]
    sm.acc_timestamp[:count] = z["acc_ts"]
    sm.account_index.insert_batch(keys, np.arange(count, dtype=np.uint32))
    sm._register_accounts(
        np.arange(count, dtype=np.int32), z["acc_ledger"], z["acc_flags"],
        np.ones(count, dtype=bool),
    )
    sm._write_balances(
        np.arange(count, dtype=np.int32),
        z["bal_dp"], z["bal_dpo"], z["bal_cp"], z["bal_cpo"],
    )
    # Checkpoint state lives in the grid — rewind the free set to the
    # checkpoint and re-attach manifests / fences / log blocks (posted +
    # history grooves included).
    sm.grid.free_set.restore(z["free_set"].tobytes())
    sm.grid.drop_cache()
    sm.grid.block_cks.update(
        block_cks_map if block_cks_map is not None else block_checksums(blob)
    )
    for name, tree in content_trees(sm):
        tree.restore(z[f"{name}_manifest"])
        tree.attach_fences(z[f"{name}_fences"], z[f"{name}_fence_counts"])
        # Storm flag BEFORE the job descriptor: a restored (planned)
        # storm job supersedes a stale request, never the reverse.
        storm = z.get(f"{name}_storm")
        if storm is not None and len(storm):
            tree.restore_storm(int(storm[0]))
        job = z[f"{name}_job"]
        if len(job):
            tree.restore_job(
                int(job[0]), int(job[1]), int(job[2]),
                z[f"{name}_job_resv"].tolist(),
            )
    for name, dlog in content_logs(sm):
        dlog.restore(z[f"{name}_blocks"], z[f"{name}_tail"])
    if rebuild_bloom:
        rebuild_transfer_bloom(sm)
    sm.prepare_timestamp = int(z["prepare_timestamp"])
    replica.committed_timestamp_max = int(z["prepare_timestamp"])
    sm.commit_timestamp = int(z["commit_timestamp"])
    replica.config_epoch = int(z["config_epoch"])
    replica.superblock.state.config_epoch = replica.config_epoch
    replica.slot_epoch = {
        int(r["slot"]): int(r["epoch"]) for r in z["slot_epochs"]
    }

    replies = z["client_replies"].tobytes()
    offset = 0
    clients: Dict[int, ClientSession] = {}
    for rec in z["client_table"]:
        sess = ClientSession(session=int(rec["session"]))
        sess.last_op = int(rec["last_op"])
        sess.request = int(rec["request"])
        rlen = int(rec["reply_len"])
        if rlen:
            sess.reply = Message.from_bytes(replies[offset : offset + rlen])
            offset += rlen
        clients[_join(rec["client_lo"], rec["client_hi"])] = sess
    # Rebuild in LRU order (rows are stored sorted by client id for byte
    # determinism; dict insertion order must be recency order — replica
    # _evict_lru_client pops the front). last_op is unique per session
    # (one op commits one request); the id tiebreak is belt-and-braces.
    for cid in sorted(clients, key=lambda c: (clients[c].last_op, c)):
        replica.clients[cid] = clients[cid]
