// create_transfers_exact: the fixed-point sweep commit of one
// order-dependent batch (linked chains, pending post/void, balancing
// clamps, limit and history accounts).
//
// Replaces the reference package's ops/commit_exact.py
// create_transfers_exact (the jit entry at :902; impl
// create_transfers_exact_impl, :397; _apply, :866). The ladders, the sweep
// and the rollback follow it rung for rung; see its docstring for why the
// fixed point equals the serial execution.
//
// What bounds it on this card: bytes, then latency. The update is out of
// place, as create_transfers_fast's is (a bail keeps the pre-batch state),
// so the four (A, 4) balance tables are read once and written once:
// 128 MiB at A = 2^20, against about 4 MB of batch, pending context, plan
// and outputs. Each sweep then moves its scan lanes through device memory
// (about 12.6 MB with chains and post/void at n = 8192, mostly L2-resident)
// and waits on four grid-wide barriers, so a batch that needs many sweeps
// is bound by the barriers' latency, not by a rate.
//
// Design: one cooperative persistent kernel (cudaLaunchCooperativeKernel,
// as many blocks as fit on the SMs, at most two per SM); grid.sync()
// separates the phases and the loop never returns to the host.
//   0. Copy the four tables into the new ones (16-byte loads and stores),
//      noting whether any old row's pending + posted already overflows;
//      evaluate the static ladders of both kinds of event once.
//   1. Seed ("sweep 0"): the dynamic ladder against the pre-batch balances.
//   2. Sweeps, at most max_sweeps, each:
//      a. chain outcome: a failing event stamps its chain with the sweep
//         number (has_chains only);
//      b. one exclusive prefix sum per lane over the sorted postings: 256
//         positions per block tile, warp-shuffle scans, tile totals to
//         device memory. Lanes are u32 limbs summed in u64 (2^14 terms of
//         < 2^32 cannot wrap), 24 for the cross-chain view (mask A), 24
//         for the same-chain view (mask B, has_chains), and 4 for the
//         fulfillment prefix over the group-sorted events (has_pv);
//      c. every record's observed balances: segmented sum = global
//         exclusive prefix - the prefix at its segment head (as the
//         reference's `excl - excl[head_pos]`), added to the base row, the
//         pending removals subtracted with saturation (a borrow counts as
//         this sweep's underflow);
//      d. the dynamic ladder per event; a change of ok or of the masked
//         amount marks the sweep unstable. A stable sweep ends the loop;
//         its codes and observations are the result, with no re-evaluation.
//   3. Linked-chain rollback: each chain's first failing event keeps its
//      code (atomicMin of the failing indices), LINKED_EVENT_CHAIN_OPEN is
//      kept, the rest of a failed chain becomes LINKED_EVENT_FAILED; then
//      the u128 posting adds (common.cuh atomic_add_u128).
//   4. The pending removals of post/void, after every add landed
//      (atomic_sub_u128: a wrap is the reference's scatter_sub underflow).
//   5. Pending + posted of every touched row on the new tables, or of every
//      row if an old row already overflowed (the reference's whole-table
//      check; subtractions can cure a touched row's old overflow).
// bail = not stable | any add overflow, sub underflow or pending + posted
// overflow | the last sweep's speculative underflow. The sweep count is
// added to a device counter that the host reads only when it asks.
//
// External-base mode (the balance tables sharded over a device mesh; the
// reference's balance_read / balance_apply hooks, parallel/sharding.py
// :215-268): the caller gives the pre-batch balances of the 2n posting
// records (4 x (2n, 4), gathered from the shards by sharded_read.cu) in
// place of the tables, phase 0 copies no table, and phases 3-5 post
// nothing: each event writes its effective debit and credit slots and its
// posting masks (add to pending, add to posted, remove from pending, the
// reference's _apply masks, :866-874) for sharded_apply.cu to post on
// every shard. bail = not stable | the last sweep's speculative underflow.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using tb::add3;
using tb::from_u128;
using tb::to_u128;
using tb::u128;
using tb::Wide;
using tb::wide_gt;

constexpr int kBlock = 256;  // threads per block = positions per scan tile
constexpr int kLanes = 52;

// TransferFlags and AccountFlags bits (flags.py; upstream
// tigerbeetle.zig:107-120, :88-96).
constexpr uint32_t F_PENDING = 1u << 1;
constexpr uint32_t F_POST = 1u << 2;
constexpr uint32_t F_VOID = 1u << 3;
constexpr uint32_t F_BAL_DR = 1u << 4;
constexpr uint32_t F_BAL_CR = 1u << 5;
constexpr uint32_t F_PADDING = 0xFFFFu & ~0x3Fu;
constexpr uint32_t AF_DEBITS_MUST_NOT_EXCEED_CREDITS = 1u << 1;
constexpr uint32_t AF_CREDITS_MUST_NOT_EXCEED_DEBITS = 1u << 2;

// CreateTransferResult codes (results.py; ops/commit_exact.py asserts
// these against the enum).
constexpr uint32_t LINKED_EVENT_FAILED = 1;
constexpr uint32_t LINKED_EVENT_CHAIN_OPEN = 2;
constexpr uint32_t RESERVED_FLAG = 4;
constexpr uint32_t ID_MUST_NOT_BE_ZERO = 5;
constexpr uint32_t ID_MUST_NOT_BE_INT_MAX = 6;
constexpr uint32_t FLAGS_ARE_MUTUALLY_EXCLUSIVE = 7;
constexpr uint32_t PENDING_ID_MUST_BE_ZERO = 13;
constexpr uint32_t PENDING_ID_MUST_NOT_BE_ZERO = 14;
constexpr uint32_t PENDING_ID_MUST_NOT_BE_INT_MAX = 15;
constexpr uint32_t PENDING_ID_MUST_BE_DIFFERENT = 16;
constexpr uint32_t TIMEOUT_RESERVED_FOR_PENDING_TRANSFER = 17;
constexpr uint32_t AMOUNT_MUST_NOT_BE_ZERO = 18;
constexpr uint32_t LEDGER_MUST_NOT_BE_ZERO = 19;
constexpr uint32_t CODE_MUST_NOT_BE_ZERO = 20;
constexpr uint32_t DEBIT_ACCOUNT_NOT_FOUND = 21;
constexpr uint32_t CREDIT_ACCOUNT_NOT_FOUND = 22;
constexpr uint32_t ACCOUNTS_MUST_HAVE_THE_SAME_LEDGER = 23;
constexpr uint32_t TRANSFER_MUST_HAVE_THE_SAME_LEDGER_AS_ACCOUNTS = 24;
constexpr uint32_t EXCEEDS_PENDING_TRANSFER_AMOUNT = 31;
constexpr uint32_t PENDING_TRANSFER_HAS_DIFFERENT_AMOUNT = 32;
constexpr uint32_t PENDING_TRANSFER_ALREADY_POSTED = 33;
constexpr uint32_t PENDING_TRANSFER_ALREADY_VOIDED = 34;
constexpr uint32_t PENDING_TRANSFER_EXPIRED = 35;
constexpr uint32_t OVERFLOWS_DEBITS_PENDING = 47;
constexpr uint32_t OVERFLOWS_CREDITS_PENDING = 48;
constexpr uint32_t OVERFLOWS_DEBITS_POSTED = 49;
constexpr uint32_t OVERFLOWS_CREDITS_POSTED = 50;
constexpr uint32_t OVERFLOWS_DEBITS = 51;
constexpr uint32_t OVERFLOWS_CREDITS = 52;
constexpr uint32_t OVERFLOWS_TIMEOUT = 53;
constexpr uint32_t EXCEEDS_CREDITS = 54;
constexpr uint32_t EXCEEDS_DEBITS = 55;

// Posting masks of the external-base mode (sharded_apply.cu reads them).
constexpr uint8_t M_ADD_PEND = 1;
constexpr uint8_t M_ADD_POST = 2;
constexpr uint8_t M_SUB_PEND = 4;

constexpr int FULFILL_POSTED = 0;
constexpr int FULFILL_VOIDED = 1;
constexpr unsigned long long NS_PER_S = 1000000000ull;

// Static per-event bits (phase 0).
constexpr uint32_t B_PEND = 1u << 0;
constexpr uint32_t B_BAL_DR = 1u << 1;
constexpr uint32_t B_BAL_CR = 1u << 2;
constexpr uint32_t B_PV = 1u << 3;
constexpr uint32_t B_POST = 1u << 4;
constexpr uint32_t B_DR_LIMIT = 1u << 5;
constexpr uint32_t B_CR_LIMIT = 1u << 6;
constexpr uint32_t B_TS_OVER = 1u << 7;
constexpr uint32_t B_EXPIRED = 1u << 8;
constexpr uint32_t B_FOUND = 1u << 9;

// Control words.
constexpr int C_OLD_OVER = 0;  // an old row's pending + posted overflows
constexpr int C_OVER = 1;      // posting overflow or underflow
constexpr int C_SWEEP = 2;     // then [unstable] and [under] per sweep

size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Scratch layout: byte offsets of each region, for n events.
struct Layout {
  size_t bits, reg_code, pv_code, amount0, resolved, eff_dr, eff_cr, ok, amt,
      stamp, cfirst, epv, obs, loc, tot, ctrl, end;
  size_t ctrl_bytes;
};

Layout layout(long long n, long long max_sweeps) {
  long long e2 = 2 * n;
  long long tiles = (e2 + kBlock - 1) / kBlock;
  Layout l{};
  size_t o = 0;
  auto take = [&](size_t& field, size_t bytes) {
    field = o;
    o = align16(o + bytes);
  };
  take(l.bits, 4 * n);
  take(l.reg_code, 4 * n);
  take(l.pv_code, 4 * n);
  take(l.amount0, 16 * n);
  take(l.resolved, 16 * n);
  take(l.eff_dr, 4 * n);
  take(l.eff_cr, 4 * n);
  take(l.ok, 4 * n);
  take(l.amt, 16 * n);
  take(l.stamp, 4 * n);
  take(l.cfirst, 4 * n);
  take(l.epv, 4 * n);
  take(l.obs, 16 * 4 * e2);
  take(l.loc, 8 * (size_t)kLanes * e2);
  take(l.tot, 8 * (size_t)kLanes * tiles);
  l.ctrl_bytes = 4 * (C_SWEEP + 2 * max_sweeps);
  take(l.ctrl, l.ctrl_bytes);
  l.end = o;
  return l;
}

struct Args {
  const uint4 *dp, *dpo, *cp, *cpo;
  const uint32_t *acc_ledger, *acc_flags;
  uint4 *ndp, *ndpo, *ncp, *ncpo;
  const uint4* id;
  const int32_t *dr_slot, *cr_slot;
  const uint4 *amount, *pending_id;
  const uint32_t *timeout, *ledger, *code, *flags;
  const uint2* timestamp;
  const uint32_t* host_code;
  const bool* p_found;
  const uint4* p_amount;
  const int32_t *p_dr, *p_cr;
  const uint2* p_ts;
  const uint32_t* p_timeout;
  const int32_t *p_base, *p_group;
  const int32_t* chain_id;
  const int32_t *perm, *inv_perm, *head_pos, *sub_head_pos;
  const int32_t *f_perm, *f_inv_perm, *f_head_pos, *f_sub_head_pos;
  uint32_t* codes;
  uint4* amounts;
  uint4 *dr_dp, *dr_dpo, *dr_cp, *dr_cpo;
  uint4 *cr_dp, *cr_dpo, *cr_cp, *cr_cpo;
  bool* bail;
  unsigned long long* sweep_stats;  // [sum, count, max] of sweeps
  // external-base mode: the records' base balances in, the posting out
  const uint4 *base_dp, *base_dpo, *base_cp, *base_cpo;
  int32_t *out_eff_dr, *out_eff_cr;
  uint8_t* out_mask;
  bool external;
  // scratch
  uint32_t *bits, *reg_code, *pv_code;
  uint4 *amount0, *resolved;
  int32_t *eff_dr, *eff_cr;
  uint32_t* ok;
  uint4* amt;
  uint32_t *stamp, *cfirst, *epv;
  uint4* obs;  // [2n][4]: record order, fields dp, dpo, cp, cpo
  unsigned long long *loc, *tot;
  uint32_t* ctrl;
  long long a;
  int n, max_sweeps;
  bool has_pv, has_chains;
};

// Loads of what other blocks wrote in an earlier phase go through L2
// (the SM's L1 may hold a line from before the barrier).
template <class T>
__device__ __forceinline__ T ld(const T* p) {
  return __ldcg(p);
}

__device__ __forceinline__ bool is_zero(uint4 v) {
  return (v.x | v.y | v.z | v.w) == 0;
}
__device__ __forceinline__ bool is_max(uint4 v) {
  return (v.x & v.y & v.z & v.w) == 0xFFFFFFFFu;
}
__device__ __forceinline__ unsigned long long u64_of(uint2 v) {
  return ((unsigned long long)v.y << 32) | v.x;
}
__device__ __forceinline__ uint32_t limb(uint4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ void rung(uint32_t& c, bool cond, uint32_t r) {
  if (c == 0 && cond) c = r;
}
// Nonzero minimum (results are ordered by precedence).
__device__ __forceinline__ uint32_t merge(uint32_t c, uint32_t host) {
  return (c == 0 || (host != 0 && host < c)) ? host : c;
}
__device__ __forceinline__ long long clip(long long s, long long a) {
  return s < 0 ? 0 : s >= a ? a - 1 : s;
}
// A scatter's row: a negative slot counts from the end (the reference's
// drop-mode scatter), and what is still outside [0, A) is dropped (-1).
__device__ __forceinline__ long long scatter_row(long long s, long long a) {
  if (s < 0) s += a;
  return (s >= 0 && s < a) ? s : -1;
}

__device__ __forceinline__ int32_t rec_slot(const Args& g, int r) {
  return r < g.n ? g.eff_dr[r] : g.eff_cr[r - g.n];
}

// --- phase 0: the static ladders (reference _static_ladder,
// _pv_static_ladder, _timeout_overflows, _pending_expired) --------------

__device__ void event_static(const Args& g, int e) {
  uint32_t flags = g.flags[e];
  bool pend = flags & F_PENDING, post = flags & F_POST, void_ = flags & F_VOID;
  bool bal_dr = flags & F_BAL_DR, bal_cr = flags & F_BAL_CR;
  bool balancing = bal_dr || bal_cr;
  bool pv = post || void_;
  uint4 id = g.id[e], amount = g.amount[e], pid = g.pending_id[e];
  uint4 p_amount = g.p_amount[e];
  bool found = g.p_found[e];
  uint32_t host = g.host_code[e];
  uint32_t timeout = g.timeout[e];

  // shared prefix (state_machine.zig:1243-1253)
  uint32_t shared = 0;
  rung(shared, (flags & F_PADDING) != 0, RESERVED_FLAG);
  rung(shared, is_zero(id), ID_MUST_NOT_BE_ZERO);
  rung(shared, is_max(id), ID_MUST_NOT_BE_INT_MAX);

  int32_t dr = g.dr_slot[e], cr = g.cr_slot[e];
  uint32_t dr_ledger = g.acc_ledger[clip(dr, g.a)];
  uint32_t cr_ledger = g.acc_ledger[clip(cr, g.a)];
  uint32_t reg = shared;
  if (!pv) {
    rung(reg, !is_zero(pid), PENDING_ID_MUST_BE_ZERO);
    rung(reg, !pend && timeout != 0, TIMEOUT_RESERVED_FOR_PENDING_TRANSFER);
    rung(reg, !balancing && is_zero(amount), AMOUNT_MUST_NOT_BE_ZERO);
    rung(reg, g.ledger[e] == 0, LEDGER_MUST_NOT_BE_ZERO);
    rung(reg, g.code[e] == 0, CODE_MUST_NOT_BE_ZERO);
    rung(reg, dr < 0, DEBIT_ACCOUNT_NOT_FOUND);
    rung(reg, cr < 0, CREDIT_ACCOUNT_NOT_FOUND);
    rung(reg, dr_ledger != cr_ledger, ACCOUNTS_MUST_HAVE_THE_SAME_LEDGER);
    rung(reg, g.ledger[e] != dr_ledger,
         TRANSFER_MUST_HAVE_THE_SAME_LEDGER_AS_ACCOUNTS);
  }

  // resolved post/void amount: t.amount if > 0 else p.amount
  uint4 resolved = is_zero(amount) ? p_amount : amount;
  u128 res = to_u128(resolved), pam = to_u128(p_amount);
  uint32_t pvc = shared;
  if (pv) {
    rung(pvc, post && void_, FLAGS_ARE_MUTUALLY_EXCLUSIVE);
    rung(pvc, pend, FLAGS_ARE_MUTUALLY_EXCLUSIVE);
    rung(pvc, balancing, FLAGS_ARE_MUTUALLY_EXCLUSIVE);
    rung(pvc, is_zero(pid), PENDING_ID_MUST_NOT_BE_ZERO);
    rung(pvc, is_max(pid), PENDING_ID_MUST_NOT_BE_INT_MAX);
    rung(pvc, to_u128(pid) == to_u128(id), PENDING_ID_MUST_BE_DIFFERENT);
    rung(pvc, timeout != 0, TIMEOUT_RESERVED_FOR_PENDING_TRANSFER);
    rung(pvc, found && res > pam, EXCEEDS_PENDING_TRANSFER_AMOUNT);
    rung(pvc, found && void_ && res < pam,
         PENDING_TRANSFER_HAS_DIFFERENT_AMOUNT);
    rung(pvc, g.p_base[e] == FULFILL_POSTED, PENDING_TRANSFER_ALREADY_POSTED);
    rung(pvc, g.p_base[e] == FULFILL_VOIDED, PENDING_TRANSFER_ALREADY_VOIDED);
  }

  // t.timestamp + t.timeout * 1e9 > maxInt(u64) (state_machine.zig:1326)
  unsigned long long ts = u64_of(g.timestamp[e]);
  unsigned long long tns = (unsigned long long)timeout * NS_PER_S;
  bool ts_over = ts + tns < ts;
  // p.timeout > 0 and t.timestamp >= p.timestamp + p.timeout * 1e9
  uint32_t p_timeout = g.p_timeout[e];
  unsigned long long p_ts = u64_of(g.p_ts[e]);
  unsigned long long deadline = p_ts + (unsigned long long)p_timeout * NS_PER_S;
  bool expired = p_timeout != 0 && deadline >= p_ts && ts >= deadline;

  bool dr_limit = g.acc_flags[clip(dr, g.a)] & AF_DEBITS_MUST_NOT_EXCEED_CREDITS;
  bool cr_limit = g.acc_flags[clip(cr, g.a)] & AF_CREDITS_MUST_NOT_EXCEED_DEBITS;

  uint32_t bits = (pend ? B_PEND : 0) | (bal_dr ? B_BAL_DR : 0) |
                  (bal_cr ? B_BAL_CR : 0) | (pv ? B_PV : 0) |
                  (post ? B_POST : 0) | (dr_limit ? B_DR_LIMIT : 0) |
                  (cr_limit ? B_CR_LIMIT : 0) | (ts_over ? B_TS_OVER : 0) |
                  (expired ? B_EXPIRED : 0) | (found ? B_FOUND : 0);
  g.bits[e] = bits;
  g.reg_code[e] = merge(reg, host);
  g.pv_code[e] = merge(pvc, host);
  // The balancing zero-amount sentinel is maxInt(u64), not u128.
  uint4 a0 = (balancing && is_zero(amount))
                 ? make_uint4(0xFFFFFFFFu, 0xFFFFFFFFu, 0, 0)
                 : amount;
  g.amount0[e] = pv ? resolved : a0;
  g.resolved[e] = resolved;
  g.eff_dr[e] = pv ? g.p_dr[e] : dr;
  g.eff_cr[e] = pv ? g.p_cr[e] : cr;
}

struct Obs {
  u128 dp, dpo, cp, cpo;
};

__device__ __forceinline__ Obs load_obs(const Args& g, int r) {
  const uint4* o = g.obs + 4 * (size_t)r;
  return Obs{to_u128(ld(o)), to_u128(ld(o + 1)), to_u128(ld(o + 2)),
             to_u128(ld(o + 3))};
}

__device__ __forceinline__ Obs base_obs(const Args& g, int r) {
  if (g.external) {
    return Obs{to_u128(g.base_dp[r]), to_u128(g.base_dpo[r]),
               to_u128(g.base_cp[r]), to_u128(g.base_cpo[r])};
  }
  long long s = clip(rec_slot(g, r), g.a);
  return Obs{to_u128(g.dp[s]), to_u128(g.dpo[s]), to_u128(g.cp[s]),
             to_u128(g.cpo[s])};
}

// The dynamic ladder (reference evaluate, :690-761) for event e.
__device__ void evaluate(const Args& g, int e, const Obs& dr, const Obs& cr,
                         bool ep, bool ev, uint32_t& code_out,
                         u128& amt_out) {
  uint32_t bits = g.bits[e];
  if (bits & B_PV) {
    // in-batch fulfillment rungs precede EXPIRED (oracle order)
    uint32_t c = g.pv_code[e];
    rung(c, ep, PENDING_TRANSFER_ALREADY_POSTED);
    rung(c, ev, PENDING_TRANSFER_ALREADY_VOIDED);
    rung(c, (bits & B_FOUND) && (bits & B_EXPIRED), PENDING_TRANSFER_EXPIRED);
    code_out = c;
    amt_out = to_u128(g.resolved[e]);
    return;
  }
  uint32_t c = g.reg_code[e];
  u128 amt = to_u128(g.amount0[e]);
  bool pend = bits & B_PEND;
  // Balancing clamps (state_machine.zig:1286-1306).
  Wide dr_bal = add3(dr.dp, dr.dpo, 0);
  u128 avail_d = (dr_bal.hi == 0 && dr.cpo >= dr_bal.lo) ? dr.cpo - dr_bal.lo : 0;
  if (bits & B_BAL_DR) {
    if (avail_d < amt) amt = avail_d;
    rung(c, amt == 0, EXCEEDS_CREDITS);
  }
  Wide cr_bal = add3(cr.cp, cr.cpo, 0);
  u128 avail_c = (cr_bal.hi == 0 && cr.dpo >= cr_bal.lo) ? cr.dpo - cr_bal.lo : 0;
  u128 amt2 = amt;
  if (bits & B_BAL_CR) {
    if (avail_c < amt2) amt2 = avail_c;
    rung(c, amt2 == 0 && amt != 0, EXCEEDS_DEBITS);
  }
  amt = amt2;
  // Overflow rungs (state_machine.zig:1308-1324), in reference order.
  rung(c, pend && amt + dr.dp < amt, OVERFLOWS_DEBITS_PENDING);
  rung(c, pend && amt + cr.cp < amt, OVERFLOWS_CREDITS_PENDING);
  rung(c, amt + dr.dpo < amt, OVERFLOWS_DEBITS_POSTED);
  rung(c, amt + cr.cpo < amt, OVERFLOWS_CREDITS_POSTED);
  Wide d_sum = add3(dr.dp, dr.dpo, amt);
  Wide c_sum = add3(cr.cp, cr.cpo, amt);
  rung(c, d_sum.hi != 0, OVERFLOWS_DEBITS);
  rung(c, c_sum.hi != 0, OVERFLOWS_CREDITS);
  rung(c, bits & B_TS_OVER, OVERFLOWS_TIMEOUT);
  // Limit flags (tigerbeetle.zig:31-39).
  rung(c, (bits & B_DR_LIMIT) && wide_gt(d_sum, dr.cpo), EXCEEDS_CREDITS);
  rung(c, (bits & B_CR_LIMIT) && wide_gt(c_sum, cr.dpo), EXCEEDS_DEBITS);
  code_out = c;
  amt_out = amt;
}

__device__ __forceinline__ bool chain_ok(const Args& g, int e, uint32_t stamp,
                                         bool ok) {
  return g.has_chains ? ld(g.stamp + g.chain_id[e]) != stamp : ok;
}

// Lane l of sorted posting position p (l < 48) or of group-sorted event
// position p (l >= 48), as the reference's `stacked` and fulfillment `v`.
// lanes 0-23 mask A, 24-47 mask B; within each, 4 limbs of dp_add, dp_sub,
// dpo_add, cp_add, cp_sub, cpo_add; 48-49 A post/void, 50-51 B post/void.
__device__ __forceinline__ bool lane_active(const Args& g, int l) {
  if (l >= 48) return g.has_pv && (l < 50 || g.has_chains);
  if (l >= 24 && !g.has_chains) return false;
  int kind = ((l % 24) / 4) % 3;
  return kind != 1 || g.has_pv;
}

__device__ unsigned long long lane_value(const Args& g, int p, int l,
                                         uint32_t stamp) {
  int e2 = 2 * g.n;
  if (l >= 48) {
    if (p >= g.n) return 0;
    int e = g.f_perm[p];
    bool ok = ld(g.ok + e) != 0;
    bool cok = chain_ok(g, e, stamp, ok);
    bool on = (l < 50) ? (ok && cok) : (ok && !cok);
    uint32_t bits = g.bits[e];
    bool post = (bits & B_PV) && (bits & B_POST);
    bool void_ = (bits & B_PV) && !(bits & B_POST);
    return on && ((l & 1) ? void_ : post);
  }
  if (p >= e2) return 0;
  int r = g.perm[p];
  bool is_dr = r < g.n;
  int e = is_dr ? r : r - g.n;
  int field = (l % 24) / 4;
  if ((field < 3) != is_dr) return 0;  // a record carries its side's lanes
  bool ok = ld(g.ok + e) != 0;
  bool cok = chain_ok(g, e, stamp, ok);
  if (!((l < 24) ? (ok && cok) : (ok && !cok))) return 0;
  uint32_t bits = g.bits[e];
  bool pv = bits & B_PV, pend = bits & B_PEND;
  int kind = field % 3, k = l & 3;
  if (kind == 0) return (pend && !pv) ? limb(ld(g.amt + e), k) : 0;
  if (kind == 1) return pv ? limb(g.p_amount[e], k) : 0;
  bool post_grp = (!pend && !pv) || (pv && (bits & B_POST));
  return post_grp ? limb(ld(g.amt + e), k) : 0;
}

__shared__ unsigned long long s_warp[kBlock / 32];

// Block-wide inclusive sum of one u64 per thread.
__device__ unsigned long long block_incl_sum(unsigned long long v) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long x = v;
  for (int o = 1; o < 32; o <<= 1) {
    unsigned long long y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  unsigned long long before = 0;
  for (int w = 0; w < warp; ++w) before += s_warp[w];
  __syncthreads();
  return before + x;
}

// Segmented exclusive sum of lane l at position p with segment head h.
__device__ __forceinline__ unsigned long long seg(const Args& g,
                                                  const unsigned long long* off,
                                                  int l, int p, int h) {
  int e2 = 2 * g.n;
  unsigned long long at_p = ld(g.loc + (size_t)l * e2 + p) + off[(p / kBlock) * kLanes + l];
  unsigned long long at_h = ld(g.loc + (size_t)l * e2 + h) + off[(h / kBlock) * kLanes + l];
  return at_p - at_h;
}

// The u128 (mod 2^128) of four u32-limb sums.
__device__ __forceinline__ u128 limbs_sum(const unsigned long long s[4]) {
  return (u128)s[0] + ((u128)s[1] << 32) + ((u128)s[2] << 64) +
         ((u128)s[3] << 96);
}

__device__ void post_row(const Args& g, uint4* table, int32_t slot, uint4 v,
                         bool sub, bool& over) {
  long long r = scatter_row(slot, g.a);
  if (r < 0) return;
  uint32_t* row = reinterpret_cast<uint32_t*>(table + r);
  over |= sub ? tb::atomic_sub_u128(row, v) : tb::atomic_add_u128(row, v);
}

__device__ __forceinline__ bool row_overflows(const uint4* dp, const uint4* dpo,
                                              const uint4* cp, const uint4* cpo,
                                              long long r) {
  return tb::sum_overflows(ld(dp + r), ld(dpo + r)) |
         tb::sum_overflows(ld(cp + r), ld(cpo + r));
}

__global__ void __launch_bounds__(kBlock)
    exact_kernel(Args g) {
  extern __shared__ unsigned long long off[];  // [tiles][kLanes] prefixes
  cg::grid_group grid = cg::this_grid();
  const int n = g.n, e2 = 2 * n;
  const int tiles = (e2 + kBlock - 1) / kBlock;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;

  // Phase 0: copy the tables, the static ladders.
  bool over = false;
  for (long long r = tid; !g.external && r < g.a; r += nthreads) {
    uint4 dp = g.dp[r], dpo = g.dpo[r], cp = g.cp[r], cpo = g.cpo[r];
    g.ndp[r] = dp;
    g.ndpo[r] = dpo;
    g.ncp[r] = cp;
    g.ncpo[r] = cpo;
    over |= tb::sum_overflows(dp, dpo) | tb::sum_overflows(cp, cpo);
  }
  if (over) atomicOr(g.ctrl + C_OLD_OVER, 1u);
  for (long long e = tid; e < n; e += nthreads) {
    event_static(g, (int)e);
    g.stamp[e] = 0;
    g.cfirst[e] = 0xFFFFFFFFu;
  }
  for (long long i = tid; i < 4ll * e2; i += nthreads) {
    g.obs[i] = make_uint4(0, 0, 0, 0);
  }
  grid.sync();

  // Phase 1: seed against the pre-batch balances, no fulfillments.
  for (long long e = tid; e < n; e += nthreads) {
    uint32_t c;
    u128 a;
    evaluate(g, (int)e, base_obs(g, (int)e), base_obs(g, (int)e + n), false,
             false, c, a);
    g.ok[e] = c == 0;
    g.amt[e] = from_u128(c == 0 ? a : 0);
    g.codes[e] = c;
  }
  grid.sync();

  // Phase 2: the sweeps.
  bool stable = false;
  int sweeps = 0;
  for (int it = 0; it < g.max_sweeps; ++it) {
    const uint32_t stamp = it + 1;
    uint32_t* unstable = g.ctrl + C_SWEEP + it;
    uint32_t* under = g.ctrl + C_SWEEP + g.max_sweeps + it;
    // a. chain outcomes
    if (g.has_chains) {
      for (long long e = tid; e < n; e += nthreads) {
        if (!ld(g.ok + e)) g.stamp[g.chain_id[e]] = stamp;
      }
      grid.sync();
    }
    // b. per-tile exclusive prefixes of every lane
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int p = t * kBlock + threadIdx.x;
      for (int l = 0; l < kLanes; ++l) {
        if (!lane_active(g, l)) continue;
        unsigned long long v = lane_value(g, p, l, stamp);
        unsigned long long incl = block_incl_sum(v);
        if (p < e2) g.loc[(size_t)l * e2 + p] = incl - v;
        if (threadIdx.x == kBlock - 1) g.tot[(size_t)t * kLanes + l] = incl;
      }
    }
    grid.sync();
    // c. observed balances per record; fulfillment per event
    for (int l = threadIdx.x; l < kLanes; l += blockDim.x) {
      unsigned long long run = 0;
      bool act = lane_active(g, l);
      for (int t = 0; t < tiles; ++t) {
        off[t * kLanes + l] = run;
        if (act) run += ld(g.tot + (size_t)t * kLanes + l);
      }
    }
    __syncthreads();
    bool und = false;
    for (long long q = tid; q < e2; q += nthreads) {
      int p = (int)q;
      int r = g.perm[p];
      int ha = g.head_pos[p], hb = g.sub_head_pos[p];
      u128 d[6];
      for (int f = 0; f < 6; ++f) {
        unsigned long long s[4];
        for (int k = 0; k < 4; ++k) {
          int la = 4 * f + k;
          s[k] = lane_active(g, la) ? seg(g, off, la, p, ha) : 0;
          if (lane_active(g, 24 + la)) s[k] += seg(g, off, 24 + la, p, hb);
        }
        d[f] = limbs_sum(s);
      }
      Obs b = base_obs(g, r);
      u128 dp = b.dp + d[0], cp = b.cp + d[3];
      bool ud = dp < d[1], uc = cp < d[4];
      und |= ud | uc;
      uint4* o = g.obs + 4 * (size_t)r;
      o[0] = from_u128(ud ? 0 : dp - d[1]);
      o[1] = from_u128(b.dpo + d[2]);
      o[2] = from_u128(uc ? 0 : cp - d[4]);
      o[3] = from_u128(b.cpo + d[5]);
    }
    if (und) atomicOr(under, 1u);
    if (g.has_pv) {
      for (long long q = tid; q < n; q += nthreads) {
        int p = (int)q;
        int fh = g.f_head_pos[p], fs = g.f_sub_head_pos[p];
        unsigned long long post = seg(g, off, 48, p, fh);
        unsigned long long vd = seg(g, off, 49, p, fh);
        if (g.has_chains) {
          post += seg(g, off, 50, p, fs);
          vd += seg(g, off, 51, p, fs);
        }
        g.epv[g.f_perm[p]] = (post > 0 ? 1u : 0u) | (vd > 0 ? 2u : 0u);
      }
    }
    grid.sync();
    // d. the dynamic ladder; stability
    bool moved = false;
    for (long long q = tid; q < n; q += nthreads) {
      int e = (int)q;
      uint32_t fp = g.has_pv ? ld(g.epv + e) : 0;
      uint32_t c;
      u128 a;
      evaluate(g, e, load_obs(g, e), load_obs(g, e + n), fp & 1, fp & 2, c, a);
      bool nok = c == 0;
      u128 na = nok ? a : 0;
      bool ook = ld(g.ok + e) != 0;
      u128 oa = to_u128(ld(g.amt + e));
      moved |= (nok != ook) || (na != oa);
      g.ok[e] = nok;
      g.amt[e] = from_u128(na);
      g.codes[e] = c;
    }
    if (moved) atomicOr(unstable, 1u);
    grid.sync();
    sweeps = it + 1;
    if (ld(unstable) == 0) {
      stable = true;
      break;
    }
  }
  bool under_final =
      sweeps > 0 && ld(g.ctrl + C_SWEEP + g.max_sweeps + sweeps - 1) != 0;

  // Phase 3: linked-chain rollback (reference :824-833), then the adds.
  if (g.has_chains) {
    for (long long e = tid; e < n; e += nthreads) {
      if (ld(g.codes + e) != 0) atomicMin(g.cfirst + g.chain_id[e], (uint32_t)e);
    }
    grid.sync();
  }
  over = false;
  for (long long q = tid; q < n; q += nthreads) {
    int e = (int)q;
    uint32_t c = ld(g.codes + e);
    if (g.has_chains) {
      uint32_t first = ld(g.cfirst + g.chain_id[e]);
      bool chain_fails = first != 0xFFFFFFFFu;
      bool keep = (c != 0 && first == (uint32_t)e) || c == LINKED_EVENT_CHAIN_OPEN;
      if (chain_fails && !keep) c = LINKED_EVENT_FAILED;
    }
    bool ok = c == 0;
    uint4 amount = ok ? ld(g.amt + e) : make_uint4(0, 0, 0, 0);
    g.codes[e] = c;
    g.amounts[e] = amount;
    // post-event balances for history rows (reference :845-860)
    uint32_t bits = g.bits[e];
    bool pv = bits & B_PV, pend = bits & B_PEND;
    u128 a = to_u128(amount);
    u128 a_pend = (ok && pend && !pv) ? a : 0;
    u128 a_post = (ok && !pend && !pv) ? a : 0;
    Obs dr = load_obs(g, e), cr = load_obs(g, e + n);
    g.dr_dp[e] = from_u128(dr.dp + a_pend);
    g.dr_dpo[e] = from_u128(dr.dpo + a_post);
    g.dr_cp[e] = from_u128(dr.cp);
    g.dr_cpo[e] = from_u128(dr.cpo);
    g.cr_dp[e] = from_u128(cr.dp);
    g.cr_dpo[e] = from_u128(cr.dpo);
    g.cr_cp[e] = from_u128(cr.cp + a_pend);
    g.cr_cpo[e] = from_u128(cr.cpo + a_post);
    if (g.external) {
      // _apply's masks (reference :866-874) for the shards to post
      bool post = pv && (bits & B_POST);
      g.out_eff_dr[e] = g.eff_dr[e];
      g.out_eff_cr[e] = g.eff_cr[e];
      g.out_mask[e] = (ok && pend && !pv ? M_ADD_PEND : 0) |
                      (ok && ((!pend && !pv) || post) ? M_ADD_POST : 0) |
                      (ok && pv ? M_SUB_PEND : 0);
    } else if (ok && !(pv && !(bits & B_POST))) {
      // _apply's adds (reference :882-885)
      bool to_pend = pend && !pv;
      post_row(g, to_pend ? g.ndp : g.ndpo, g.eff_dr[e], amount, false, over);
      post_row(g, to_pend ? g.ncp : g.ncpo, g.eff_cr[e], amount, false, over);
    }
  }
  grid.sync();
  // Phase 4: the pending removals of post/void (reference :886-887).
  for (long long q = tid; !g.external && q < n; q += nthreads) {
    int e = (int)q;
    if ((g.bits[e] & B_PV) && ld(g.codes + e) == 0) {
      uint4 pa = g.p_amount[e];
      post_row(g, g.ndp, g.eff_dr[e], pa, true, over);
      post_row(g, g.ncp, g.eff_cr[e], pa, true, over);
    }
  }
  grid.sync();
  // Phase 5: pending + posted of the touched rows, or of all rows
  // (reference :888-889).
  if (g.external) {
    // the shards check their own rows (sharded_apply.cu)
  } else if (ld(g.ctrl + C_OLD_OVER)) {
    for (long long r = tid; r < g.a; r += nthreads) {
      over |= row_overflows(g.ndp, g.ndpo, g.ncp, g.ncpo, r);
    }
  } else {
    for (long long q = tid; q < n; q += nthreads) {
      if (ld(g.codes + q) != 0) continue;
      long long rows[2] = {scatter_row(g.eff_dr[q], g.a),
                           scatter_row(g.eff_cr[q], g.a)};
      for (int s = 0; s < 2; ++s) {
        if (rows[s] >= 0) over |= row_overflows(g.ndp, g.ndpo, g.ncp, g.ncpo, rows[s]);
      }
    }
  }
  if (over) atomicOr(g.ctrl + C_OVER, 1u);
  grid.sync();
  if (tid == 0) {
    *g.bail = !stable || ld(g.ctrl + C_OVER) != 0 || under_final;
    atomicAdd(g.sweep_stats, (unsigned long long)sweeps);
    atomicAdd(g.sweep_stats + 1, 1ull);
    atomicMax(g.sweep_stats + 2, (unsigned long long)sweeps);
  }
}

}  // namespace

extern "C" long long tb_create_transfers_exact_scratch(long long n,
                                                       long long max_sweeps) {
  return (long long)layout(n, max_sweeps).end;
}

// ptrs: the six state tables, the four new tables, the ten TransferBatch
// fields, host_code, the eight PendingInfo fields, chain_id, the eight
// SortPlan fields, codes, amounts, dr_after (4), cr_after (4), bail,
// sweep_stats, scratch, then the external-base mode's four (2n, 4) base
// blocks and its eff_dr, eff_cr (n,) int32 and mask (n,) uint8 outputs (58
// pointers, ops/commit_exact.py names them; in external mode the four
// balance tables and the four new tables are null, otherwise the last
// seven). dims: a, n, max_sweeps, has_pv, has_chains, scratch bytes,
// external.
extern "C" int tb_create_transfers_exact(void* const* ptrs,
                                         const long long* dims, void* stream) {
  long long a = dims[0], n = dims[1], max_sweeps = dims[2];
  if (n < 1 || 2 * n > 16384 || max_sweeps < 0 || a < 1)
    return (int)cudaErrorInvalidValue;
  Layout lay = layout(n, max_sweeps);
  if ((long long)lay.end > dims[5]) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* scratch = static_cast<char*>(ptrs[50]);
  int i = 0;
  auto P = [&]() { return ptrs[i++]; };
  Args g;
  g.dp = (const uint4*)P(); g.dpo = (const uint4*)P();
  g.cp = (const uint4*)P(); g.cpo = (const uint4*)P();
  g.acc_ledger = (const uint32_t*)P(); g.acc_flags = (const uint32_t*)P();
  g.ndp = (uint4*)P(); g.ndpo = (uint4*)P(); g.ncp = (uint4*)P(); g.ncpo = (uint4*)P();
  g.id = (const uint4*)P(); g.dr_slot = (const int32_t*)P();
  g.cr_slot = (const int32_t*)P(); g.amount = (const uint4*)P();
  g.pending_id = (const uint4*)P(); g.timeout = (const uint32_t*)P();
  g.ledger = (const uint32_t*)P(); g.code = (const uint32_t*)P();
  g.flags = (const uint32_t*)P(); g.timestamp = (const uint2*)P();
  g.host_code = (const uint32_t*)P();
  g.p_found = (const bool*)P(); g.p_amount = (const uint4*)P();
  g.p_dr = (const int32_t*)P(); g.p_cr = (const int32_t*)P();
  g.p_ts = (const uint2*)P(); g.p_timeout = (const uint32_t*)P();
  g.p_base = (const int32_t*)P(); g.p_group = (const int32_t*)P();
  g.chain_id = (const int32_t*)P();
  g.perm = (const int32_t*)P(); g.inv_perm = (const int32_t*)P();
  g.head_pos = (const int32_t*)P(); g.sub_head_pos = (const int32_t*)P();
  g.f_perm = (const int32_t*)P(); g.f_inv_perm = (const int32_t*)P();
  g.f_head_pos = (const int32_t*)P(); g.f_sub_head_pos = (const int32_t*)P();
  g.codes = (uint32_t*)P(); g.amounts = (uint4*)P();
  g.dr_dp = (uint4*)P(); g.dr_dpo = (uint4*)P(); g.dr_cp = (uint4*)P(); g.dr_cpo = (uint4*)P();
  g.cr_dp = (uint4*)P(); g.cr_dpo = (uint4*)P(); g.cr_cp = (uint4*)P(); g.cr_cpo = (uint4*)P();
  g.bail = (bool*)P();
  g.sweep_stats = (unsigned long long*)P();
  P();  // scratch, ptrs[50]
  g.base_dp = (const uint4*)P(); g.base_dpo = (const uint4*)P();
  g.base_cp = (const uint4*)P(); g.base_cpo = (const uint4*)P();
  g.out_eff_dr = (int32_t*)P(); g.out_eff_cr = (int32_t*)P();
  g.out_mask = (uint8_t*)P();
  g.external = dims[6] != 0;
  g.bits = (uint32_t*)(scratch + lay.bits);
  g.reg_code = (uint32_t*)(scratch + lay.reg_code);
  g.pv_code = (uint32_t*)(scratch + lay.pv_code);
  g.amount0 = (uint4*)(scratch + lay.amount0);
  g.resolved = (uint4*)(scratch + lay.resolved);
  g.eff_dr = (int32_t*)(scratch + lay.eff_dr);
  g.eff_cr = (int32_t*)(scratch + lay.eff_cr);
  g.ok = (uint32_t*)(scratch + lay.ok);
  g.amt = (uint4*)(scratch + lay.amt);
  g.stamp = (uint32_t*)(scratch + lay.stamp);
  g.cfirst = (uint32_t*)(scratch + lay.cfirst);
  g.epv = (uint32_t*)(scratch + lay.epv);
  g.obs = (uint4*)(scratch + lay.obs);
  g.loc = (unsigned long long*)(scratch + lay.loc);
  g.tot = (unsigned long long*)(scratch + lay.tot);
  g.ctrl = (uint32_t*)(scratch + lay.ctrl);
  g.a = a;
  g.n = (int)n;
  g.max_sweeps = (int)max_sweeps;
  g.has_pv = dims[3] != 0;
  g.has_chains = dims[4] != 0;

  cudaError_t err = cudaMemsetAsync(g.ctrl, 0, lay.ctrl_bytes, s);
  if (err != cudaSuccess) return (int)err;
  int tiles = (int)((2 * n + kBlock - 1) / kBlock);
  size_t smem = (size_t)tiles * kLanes * sizeof(unsigned long long);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, exact_kernel, kBlock, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  dim3 grid(sms * (per_sm < 2 ? per_sm : 2));
  void* kargs[] = {&g};
  err = cudaLaunchCooperativeKernel((const void*)exact_kernel, grid, dim3(kBlock), kargs,
                                    smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
