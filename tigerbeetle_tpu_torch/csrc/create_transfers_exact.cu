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
// and outputs. The sweeps read only the old tables, so the copy runs
// beside them; a batch that needs many sweeps is bound by the sweeps'
// dependent steps, not by a rate.
//
// Design: one cooperative persistent kernel (cudaLaunchCooperativeKernel,
// every block resident, at most two per SM) of two kinds of block.
//   - Copy blocks (all but the sweep blocks; the launch fails where no
//     SM slot is left for one) wait out phase 0 (whose
//     random reads of the old tables a saturated memory would slow), copy
//     the four tables into the new ones with streaming 16-byte loads and
//     stores, note whether any old row's pending + posted already
//     overflows, count themselves done and exit. Nothing waits for them
//     until the posting.
//   - Sweep blocks, one a scan tile of 256 positions (ceil(2n / 256) over
//     the sorted posting records, ceil(n / 256) over the group-sorted
//     events), meet at their own grid barrier (an arrival counter), which
//     the copy blocks never join:
//     0. the static ladders and the seed ("sweep 0": the dynamic ladder
//        against the pre-batch balances), one event a thread; each tile
//        thread loads its position's record (event, side, flags, heads;
//        its base balances into shared memory) once for every sweep.
//     Sweeps, at most max_sweeps, two barriers each:
//     a. every tile's segmented exclusive sums in one pass. A record's
//        lanes are six u128 fields (dp add, dp sub, dpo add, cp add, cp
//        sub, cpo add) for the cross-chain view (mask A, slot segments)
//        and six for the same-chain view (mask B, (slot, chain)
//        sub-segments), summed mod 2^128 as the reference's u32-limb sums
//        are; an event's are its post and void counts over its pending's
//        group (has_pv). A warp-shuffle segmented scan (a lane that is
//        zero across the warp takes no shuffle, one below 2^58 is summed
//        in 64 bits), the warps' carries, then a decoupled look-back over
//        the earlier tiles of the chain (each tile publishes its
//        aggregate, then its inclusive carry, with release stores; the
//        tile before is read first, and where it ends neither view, a
//        warp reads 32 predecessors at once and stops at the first that
//        holds a head or its carry), so no record reads its segment head. Each record's observed balances (pending removals
//        subtracted with saturation; a borrow counts as this sweep's
//        underflow), each event's in-batch fulfillments.
//     b. the dynamic ladder per event; a change of ok or of the masked
//        amount marks the sweep unstable. A failing event stamps its chain
//        for the next sweep: an atomicMax of (sweep << 16 | ~index), so
//        the same word gives the chain's first failing event of the last
//        sweep to the rollback. A stable sweep ends the loop; its codes
//        and observations are the result.
//     After the loop (the copy counted done first):
//     3. linked-chain rollback (LINKED_EVENT_CHAIN_OPEN is kept, the rest
//        of a failed chain but its first failure becomes
//        LINKED_EVENT_FAILED), the outputs, then the u128 posting adds
//        (common.cuh atomic_add_u128);
//     4. the pending removals of post/void, after every add landed
//        (atomic_sub_u128: a wrap is the reference's scatter_sub
//        underflow);
//     5. pending + posted of every touched row on the new tables, or of
//        every row if an old row already overflowed (the reference's
//        whole-table check; subtractions can cure a touched row's old
//        overflow). The last sweep block to finish writes bail.
// bail = not stable | any add overflow, sub underflow or pending + posted
// overflow | the last sweep's speculative underflow. The sweep count is
// added to a device counter that the host reads only when it asks.
//
// External-base mode (the balance tables sharded over a device mesh; the
// reference's balance_read / balance_apply hooks, parallel/sharding.py
// :215-268): the caller gives the pre-batch balances of the 2n posting
// records (4 x (2n, 4), gathered from the shards by sharded_read.cu) in
// place of the tables, no copy block runs, and phases 3-5 post nothing:
// each event writes its effective debit and credit slots and its posting
// masks (add to pending, add to posted, remove from pending, the
// reference's _apply masks, :866-874) for sharded_apply.cu to post on
// every shard. bail = not stable | the last sweep's speculative underflow.
#include "common.cuh"

namespace {

using tb::add3;
using tb::from_u128;
using tb::to_u128;
using tb::u128;
using tb::Wide;
using tb::wide_gt;

constexpr int kBlock = 256;  // threads per block = positions per scan tile
constexpr int kWarps = kBlock / 32;
constexpr int kRecLanes = 6;  // u128 fields of a record, per view
constexpr int kEvLanes = 2;   // post and void counts of an event, per view

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
constexpr int C_BARRIER = 2;   // the sweep blocks' arrivals
constexpr int C_COPIED = 3;    // copy blocks done
constexpr int C_FINISHED = 4;  // sweep blocks done
constexpr int C_SWEEP = 5;     // then [unstable] and [under] per sweep

// Tile status words: (sweep + 1) << 4 | S_INCL | S_HEAD_B | S_HEAD_A.
constexpr unsigned S_HEAD_A = 1u;  // a slot-segment (or group) head in the tile
constexpr unsigned S_HEAD_B = 2u;  // a sub-segment head in the tile
constexpr unsigned S_INCL = 4u;    // the inclusive carry is published

size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

int tiles_of(long long m) { return (int)((m + kBlock - 1) / kBlock); }

// Scratch layout: byte offsets of each region, for n events. Everything
// from `ctrl` to `end` is zeroed before the launch.
struct Layout {
  size_t bits, reg_code, pv_code, amount0, resolved, eff_dr, eff_cr, ok, amt,
      epv, obs, r_agg, r_incl, e_agg, e_incl, ctrl, cf, r_status, e_status, end;
};

Layout layout(long long n, long long max_sweeps) {
  long long rt = tiles_of(2 * n), et = tiles_of(n);
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
  take(l.epv, 4 * n);
  take(l.obs, 16 * 4 * 2 * n);
  take(l.r_agg, 16 * 2 * kRecLanes * rt);
  take(l.r_incl, 16 * 2 * kRecLanes * rt);
  take(l.e_agg, 16 * 2 * kEvLanes * et);
  take(l.e_incl, 16 * 2 * kEvLanes * et);
  take(l.ctrl, 4 * (C_SWEEP + 2 * max_sweeps));
  take(l.cf, 4 * n);
  take(l.r_status, 4 * rt);
  take(l.e_status, 4 * et);
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
  uint32_t* epv;
  uint4* obs;  // [2n][4]: record order, fields dp, dpo, cp, cpo
  uint4 *r_agg, *r_incl, *e_agg, *e_incl;  // per tile: the A fields, then B
  uint32_t *ctrl, *cf, *r_status, *e_status;
  long long a;
  int n, max_sweeps;
  int r_tiles, e_tiles, copy_blocks;
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
__device__ __forceinline__ void rung(uint32_t& c, bool cond, uint32_t r) {
  if (c == 0 && cond) c = r;
}
// Nonzero minimum (results are ordered by precedence).
__device__ __forceinline__ uint32_t merge(uint32_t c, uint32_t host) {
  return (c == 0 || (host != 0 && host < c)) ? host : c;
}
// tidy: range=a:1..0x7FFFFFFF — A rows, addressed by int32 slots (the entry refuses other A)
__device__ __forceinline__ long long clip(long long s, long long a) {
  return s < 0 ? 0 : s >= a ? a - 1 : s;
}
// A scatter's row: a negative slot counts from the end (the reference's
// drop-mode scatter), and what is still outside [0, A) is dropped (-1).
// tidy: range=a:1..0x7FFFFFFF — A rows, addressed by int32 slots (the entry refuses other A)
__device__ __forceinline__ long long scatter_row(long long s, long long a) {
  if (s < 0) s += a;
  return (s >= 0 && s < a) ? s : -1;
}

// tidy: range=g.n:1..8192,r:0..16383 — r is one of the 2n posting records
__device__ __forceinline__ int32_t rec_slot(const Args& g, int r) {
  return r < g.n ? g.eff_dr[r] : g.eff_cr[r - g.n];
}

// --- phase 0: the static ladders (reference _static_ladder,
// _pv_static_ladder, _timeout_overflows, _pending_expired) --------------

// tidy: range=g.a:1..0x7FFFFFFF — the kernel's contract
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
  // tidy: allow=limb-overflow — the wrap is the test: the carry the plain version's _timeout_overflows reads (ops/commit_exact.py:276-278)
  bool ts_over = ts + tns < ts;
  // p.timeout > 0 and t.timestamp >= p.timestamp + p.timeout * 1e9
  uint32_t p_timeout = g.p_timeout[e];
  unsigned long long p_ts = u64_of(g.p_ts[e]);
  // tidy: allow=limb-overflow — a wrapped deadline is never reached: deadline >= p_ts below fails for it, as the plain version's ~over (ops/commit_exact.py:281-285)
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

// tidy: range=r:0..16383 — r is one of the 2n <= 16384 posting records
__device__ __forceinline__ Obs load_obs(const Args& g, int r) {
  const uint4* o = g.obs + 4 * (size_t)r;
  return Obs{to_u128(ld(o)), to_u128(ld(o + 1)), to_u128(ld(o + 2)),
             to_u128(ld(o + 3))};
}

// tidy: range=g.a:1..0x7FFFFFFF,g.n:1..8192,r:0..16383 — the kernel's contract; r is a posting record
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
  // tidy: allow=limb-overflow — the wrap is the test: amt + balance wraps iff the sum overflows u128, the plain version's u128.sum_overflows (ops/commit_exact.py:542-547)
  rung(c, pend && amt + dr.dp < amt, OVERFLOWS_DEBITS_PENDING);
  // tidy: allow=limb-overflow — the wrap is the test: amt + balance wraps iff the sum overflows u128, the plain version's u128.sum_overflows (ops/commit_exact.py:542-547)
  rung(c, pend && amt + cr.cp < amt, OVERFLOWS_CREDITS_PENDING);
  // tidy: allow=limb-overflow — the wrap is the test: amt + balance wraps iff the sum overflows u128, the plain version's u128.sum_overflows (ops/commit_exact.py:542-547)
  rung(c, amt + dr.dpo < amt, OVERFLOWS_DEBITS_POSTED);
  // tidy: allow=limb-overflow — the wrap is the test: amt + balance wraps iff the sum overflows u128, the plain version's u128.sum_overflows (ops/commit_exact.py:542-547)
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


// --- the sweeps' segmented scans ------------------------------------------

// K u128 lanes of the cross-chain view (a, mask A) and of the same-chain
// view (b, mask B); sums wrap mod 2^128.
template <int K>
struct Lanes {
  u128 a[K], b[K];
};

__device__ __forceinline__ u128 shfl_up_u128(u128 x, int o) {
  unsigned long long lo = __shfl_up_sync(0xFFFFFFFFu, (unsigned long long)x, o);
  unsigned long long hi = __shfl_up_sync(0xFFFFFFFFu, (unsigned long long)(x >> 64), o);
  return ((u128)hi << 64) | lo;
}

__device__ __forceinline__ u128 warp_sum_u128(u128 x) {
  for (int o = 16; o; o >>= 1) {
    unsigned long long lo = __shfl_xor_sync(0xFFFFFFFFu, (unsigned long long)x, o);
    unsigned long long hi = __shfl_xor_sync(0xFFFFFFFFu, (unsigned long long)(x >> 64), o);
    // tidy: allow=limb-overflow — mod 2^128, as the plain version's lanes (ops/commit_exact.py:485-490, _seg_excl then _limbs_mod); a true sum past 2^128 overflows the posting's atomic_add_u128: bail
    x += ((u128)hi << 64) | lo;
  }
  return x;
}

__device__ __forceinline__ unsigned ld_acquire(const uint32_t* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(uint32_t* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// One tile's scan state in shared memory (sized for the record lanes; an
// event tile uses the first kEvLanes of each).
struct ScanShared {
  Lanes<kRecLanes> warp_agg[kWarps];  // each warp's segmented total
  Lanes<kRecLanes> warp_pre[kWarps];  // the warps before it, combined
  unsigned warp_heads[kWarps], warp_pre_heads[kWarps];
  Lanes<kRecLanes> carry;  // the tile's carry from the tiles before it
};

// The head flags a segmented warp scan reads: hs[j] is whether a head
// (S_HEAD_A, S_HEAD_B) lies in the lanes step j's value covers; returns
// them after the last step.
template <int Steps>
__device__ __forceinline__ unsigned head_steps(unsigned heads, unsigned (&hs)[Steps]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < Steps; ++j) {
    hs[j] = heads;
    unsigned ph = __shfl_up_sync(0xFFFFFFFFu, heads, 1 << j);
    if (lane >= (1 << j)) heads |= ph;
  }
  return heads;
}

// Segmented inclusive scan of one u128 lane over the first 2^Steps lanes
// of the warp (the view's head bit `bit`). A lane that is zero across the
// warp takes no shuffle, and one whose values are all below 2^58 is summed
// in 64 bits (32 terms cannot carry out).
template <int Steps>
__device__ __forceinline__ u128 warp_seg_scan(u128 x, const unsigned (&hs)[Steps],
                                              unsigned bit) {
  const int lane = threadIdx.x & 31;
  if (!__any_sync(0xFFFFFFFFu, x != 0)) return x;
  if (__all_sync(0xFFFFFFFFu, (x >> 58) == 0)) {
    unsigned long long y = (unsigned long long)x;
#pragma unroll
    for (int j = 0; j < Steps; ++j) {
      unsigned long long t = __shfl_up_sync(0xFFFFFFFFu, y, 1 << j);
      if (lane >= (1 << j) && !(hs[j] & bit)) y += t;
    }
    return y;
  }
#pragma unroll
  for (int j = 0; j < Steps; ++j) {
    u128 t = shfl_up_u128(x, 1 << j);
    // tidy: allow=limb-overflow — mod 2^128, as the plain version's lanes (ops/commit_exact.py:485-490, _seg_excl then _limbs_mod); a true sum past 2^128 overflows the posting's atomic_add_u128: bail
    if (lane >= (1 << j) && !(hs[j] & bit)) x += t;
  }
  return x;
}

// Segmented inclusive scan of the block's positions in order: `heads`
// (S_HEAD_A, S_HEAD_B) marks a segment (sub-segment) head at this position
// and, on return, one at or before it in the tile; v becomes the sum from
// the last head of each view.
template <int K>
__device__ void tile_scan(ScanShared& s, unsigned& heads, Lanes<K>& v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned hs[5];
  heads = head_steps<5>(heads, hs);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v.a[k] = warp_seg_scan<5>(v.a[k], hs, S_HEAD_A);
    v.b[k] = warp_seg_scan<5>(v.b[k], hs, S_HEAD_B);
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      s.warp_agg[warp].a[k] = v.a[k];
      s.warp_agg[warp].b[k] = v.b[k];
    }
    s.warp_heads[warp] = heads;
  }
  __syncthreads();
  if (warp == 0) {  // lane w < kWarps: the combine of warps 0 .. w - 1
    const bool in = lane < kWarps;
    unsigned ws[3];
    unsigned hi = head_steps<3>(in ? s.warp_heads[lane] : 0, ws);
    unsigned he = __shfl_up_sync(0xFFFFFFFFu, hi, 1);
    if (in && lane > 0) s.warp_pre_heads[lane] = he;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      u128 xa = warp_seg_scan<3>(in ? s.warp_agg[lane].a[k] : 0, ws, S_HEAD_A);
      u128 xb = warp_seg_scan<3>(in ? s.warp_agg[lane].b[k] : 0, ws, S_HEAD_B);
      u128 ea = shfl_up_u128(xa, 1), eb = shfl_up_u128(xb, 1);
      if (in && lane > 0) {
        s.warp_pre[lane].a[k] = ea;
        s.warp_pre[lane].b[k] = eb;
      }
    }
  }
  __syncthreads();
  if (warp > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // tidy: allow=limb-overflow — mod 2^128, as the plain version's lanes (ops/commit_exact.py:485-490, _seg_excl then _limbs_mod); a true sum past 2^128 overflows the posting's atomic_add_u128: bail
      if (!(heads & S_HEAD_A)) v.a[k] += s.warp_pre[warp].a[k];
      // tidy: allow=limb-overflow — mod 2^128, as the plain version's lanes (ops/commit_exact.py:485-490, _seg_excl then _limbs_mod); a true sum past 2^128 overflows the posting's atomic_add_u128: bail
      if (!(heads & S_HEAD_B)) v.b[k] += s.warp_pre[warp].b[k];
    }
    heads |= s.warp_pre_heads[warp];
  }
}

// Tile t's value (the tile's sums from its last heads: its aggregate; or,
// with S_INCL, its inclusive carry) for the tiles after it, then its
// status word for this sweep.
template <int K>
// tidy: range=t:0..95,ver:1..0xFFFF — a tile of at most 64 + 32 (2n, n <= 8192); ver <= max_sweeps + 1 (the entry refuses max_sweeps > 0xFFFE)
__device__ void publish(uint32_t* status, uint4* buf, int t, const Lanes<K>& v,
                        unsigned flags, unsigned ver) {
  uint4* dst = buf + (size_t)t * 2 * K;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    dst[k] = from_u128(v.a[k]);
    dst[K + k] = from_u128(v.b[k]);
  }
  st_release(status + t, (ver << 4) | flags);
}

// Decoupled look-back (warp 0 of tile t > 0): the carry into tile t of
// each view, summed over the tiles before it back to the first that holds
// a head of that view or has published its inclusive carry, 32 tiles at a
// time. Every tile of the chain runs at once on its own block, so each
// publishes its aggregate without waiting.
template <int K>
// tidy: range=t:1..95,ver:1..0xFFFF — scan_tile's tile t > 0; ver as publish's
__device__ void look_back(ScanShared& s, const uint32_t* status, const uint4* agg,
                          const uint4* incl, int t, unsigned ver) {
  const int lane = threadIdx.x;
  // The tile before first: on the state machine's batches it nearly always
  // holds a head of both views, or has published its carry already.
  unsigned st = 0;
  if (lane == 0) {
    do {
      st = ld_acquire(status + t - 1);
    } while ((st >> 4) != ver);
  }
  st = __shfl_sync(0xFFFFFFFFu, st, 0);
  if ((st & S_INCL) || (st & (S_HEAD_A | S_HEAD_B)) == (S_HEAD_A | S_HEAD_B)) {
    if (lane == 0) {
      const uint4* src = ((st & S_INCL) ? incl : agg) + (size_t)(t - 1) * 2 * K;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        s.carry.a[k] = to_u128(__ldcg(src + k));
        s.carry.b[k] = to_u128(__ldcg(src + K + k));
      }
    }
    return;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) s.carry.a[k] = s.carry.b[k] = 0;
  }
  bool done_a = false, done_b = false;
  // tidy: range=k0:-33..94 — a pass begun at k0 <= 30 has lane 31 below tile 0, which stops both views: a pass begins at k0 >= -1
  for (int k0 = t - 1; !(done_a && done_b); k0 -= 32) {
    const int kk = k0 - lane;
    st = 0;
    if (kk >= 0) {
      do {
        st = ld_acquire(status + kk);
      } while ((st >> 4) != ver);
    }
    const bool stop_a = kk < 0 || (st & (S_INCL | S_HEAD_A));
    const bool stop_b = kk < 0 || (st & (S_INCL | S_HEAD_B));
    const unsigned ma = __ballot_sync(0xFFFFFFFFu, stop_a);
    const unsigned mb = __ballot_sync(0xFFFFFFFFu, stop_b);
    const int ia = ma ? __ffs(ma) - 1 : 31, ib = mb ? __ffs(mb) - 1 : 31;
    const bool use_a = !done_a && lane <= ia && kk >= 0;
    const bool use_b = !done_b && lane <= ib && kk >= 0;
    const uint4* src = ((st & S_INCL) ? incl : agg) + (size_t)(kk < 0 ? 0 : kk) * 2 * K;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      u128 xa = warp_sum_u128(use_a ? to_u128(__ldcg(src + k)) : 0);
      u128 xb = warp_sum_u128(use_b ? to_u128(__ldcg(src + K + k)) : 0);
      if (lane == 0) {
        // tidy: allow=limb-overflow — mod 2^128, as the plain version's lanes (ops/commit_exact.py:485-490, _seg_excl then _limbs_mod); a true sum past 2^128 overflows the posting's atomic_add_u128: bail
        s.carry.a[k] += xa;
        // tidy: allow=limb-overflow — mod 2^128, as the plain version's lanes (ops/commit_exact.py:485-490, _seg_excl then _limbs_mod); a true sum past 2^128 overflows the posting's atomic_add_u128: bail
        s.carry.b[k] += xb;
      }
    }
    done_a |= ma != 0;
    done_b |= mb != 0;
  }
}

// The scan of tile t of one chain (status, aggregates, inclusive carries):
// on return v is each position's inclusive segmented sum over the chain.
template <int K>
// tidy: range=t:0..95,ver:1..0xFFFF — as publish's
__device__ void scan_tile(ScanShared& s, uint32_t* status, uint4* agg, uint4* incl, int t,
                          unsigned ver, unsigned heads, Lanes<K>& v) {
  tile_scan<K>(s, heads, v);
  const bool last = threadIdx.x == kBlock - 1;
  if (t > 0) {
    if (last) publish<K>(status, agg, t, v, heads, ver);
    if (threadIdx.x < 32) look_back<K>(s, status, agg, incl, t, ver);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // tidy: allow=limb-overflow — mod 2^128, as the plain version's lanes (ops/commit_exact.py:485-490, _seg_excl then _limbs_mod); a true sum past 2^128 overflows the posting's atomic_add_u128: bail
      if (!(heads & S_HEAD_A)) v.a[k] += s.carry.a[k];
      // tidy: allow=limb-overflow — mod 2^128, as the plain version's lanes (ops/commit_exact.py:485-490, _seg_excl then _limbs_mod); a true sum past 2^128 overflows the posting's atomic_add_u128: bail
      if (!(heads & S_HEAD_B)) v.b[k] += s.carry.b[k];
    }
  }
  if (last) publish<K>(status, incl, t, v, heads | S_INCL, ver);
}

// Field f of a posting record: its side's three fields (pending add,
// pending removal, posted add); the other side's are 0.
__device__ __forceinline__ u128 record_field(int f, bool credit, bool pend, bool pv,
                                             bool post_grp, u128 amt, u128 p_amount) {
  if (f / 3 != (credit ? 1 : 0)) return 0;
  int kind = f % 3;
  return kind == 0 ? ((pend && !pv) ? amt : 0) : kind == 1 ? (pv ? p_amount : 0)
                                                           : (post_grp ? amt : 0);
}

// An event's lanes over its pending's group: a post, a void.
__device__ __forceinline__ void event_lanes(Lanes<kEvLanes>& v, bool in_a, bool in_b,
                                            bool post, bool void_) {
  v.a[0] = in_a && post;
  v.a[1] = in_a && void_;
  v.b[0] = in_b && post;
  v.b[1] = in_b && void_;
}

// tidy: range=g.a:1..0x7FFFFFFF — the kernel's contract
__device__ void post_row(const Args& g, uint4* table, int32_t slot, uint4 v,
                         bool sub, bool& over) {
  long long r = scatter_row(slot, g.a);
  if (r < 0) return;
  uint32_t* row = reinterpret_cast<uint32_t*>(table + r);
  over |= sub ? tb::atomic_sub_u128(row, v) : tb::atomic_add_u128(row, v);
}

// tidy: range=r:0..0x7FFFFFFE — a row of the A <= 2^31 - 1 tables
__device__ __forceinline__ bool row_overflows(const uint4* dp, const uint4* dpo,
                                              const uint4* cp, const uint4* cpo,
                                              long long r) {
  return tb::sum_overflows(ld(dp + r), ld(dpo + r)) |
         tb::sum_overflows(ld(cp + r), ld(cpo + r));
}

// The grid barrier of the sweep blocks (the k-th waits for k * blocks
// arrivals); the copy blocks never arrive.
__device__ void sync_sweep_blocks(uint32_t* counter, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (ld_acquire(counter) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// Rows [first, A) by `stride` of the four tables into the new ones; true
// if an old row's pending + posted overflows.
// tidy: range=g.a:1..0x7FFFFFFF,first:0..0x7FFFFFFFFF,stride:0..0x7FFFFFFF00 — a copy block's first row and the copy blocks' threads (below 2^31 blocks of 256)
__device__ bool copy_tables(const Args& g, long long first, long long stride) {
  bool over = false;
  for (long long r = first; r < g.a; r += stride) {
    uint4 dp = __ldcs(g.dp + r), dpo = __ldcs(g.dpo + r);
    uint4 cp = __ldcs(g.cp + r), cpo = __ldcs(g.cpo + r);
    __stcs(g.ndp + r, dp);
    __stcs(g.ndpo + r, dpo);
    __stcs(g.ncp + r, cp);
    __stcs(g.ncpo + r, cpo);
    over |= tb::sum_overflows(dp, dpo) | tb::sum_overflows(cp, cpo);
  }
  return over;
}

/* tidy: range=g.n:1..8192,g.max_sweeps:0..0xFFFE,g.a:1..0x7FFFFFFF,g.r_tiles:1..64,g.e_tiles:1..32,g.copy_blocks:0..0x7FFFFFFF
   — the entry refuses n < 1, 2n > 16384, max_sweeps outside [0, 0xFFFE] and A outside
   [1, 2^31 - 1] (tb_create_transfers_exact); the tiles are ceil(2n / 256) and ceil(n / 256);
   the copy blocks are the resident blocks past the sweep blocks */
__global__ void __launch_bounds__(kBlock, 2) exact_kernel(Args g) {
  const int n = g.n, e2 = 2 * n;
  const int tid = threadIdx.x;
  const int sweep_blocks = g.r_tiles + g.e_tiles;
  if ((int)blockIdx.x >= sweep_blocks) {  // a copy block
    // after phase 0, whose random reads of the old tables it would slow
    if (tid == 0) {
      while (ld_acquire(g.ctrl + C_BARRIER) < (unsigned)sweep_blocks) {
      }
    }
    __syncthreads();
    long long first = ((long long)blockIdx.x - sweep_blocks) * kBlock + tid;
    bool over = copy_tables(g, first, (long long)g.copy_blocks * kBlock);
    if (__syncthreads_or(over) && tid == 0) atomicOr(g.ctrl + C_OLD_OVER, 1u);
    if (tid == 0) {
      __threadfence();
      atomicAdd(g.ctrl + C_COPIED, 1u);
    }
    return;
  }
  __shared__ ScanShared s;
  __shared__ uint4 s_base[4][kBlock];  // a record tile's base balances
  const long long gid = (long long)blockIdx.x * kBlock + tid;
  const long long nthreads = (long long)sweep_blocks * kBlock;
  unsigned barriers = 0;
  // tidy: range=barriers:0..0x1FFFF — one barrier before the sweeps, two a sweep (at most max_sweeps <= 0xFFFE), two after
  auto barrier = [&]() { sync_sweep_blocks(g.ctrl + C_BARRIER, ++barriers * sweep_blocks); };

  // This thread's scan position, loaded once for every sweep: a posting
  // record (record tiles) or a group-sorted event (event tiles).
  const bool record_tile = (int)blockIdx.x < g.r_tiles;
  const int tile = record_tile ? (int)blockIdx.x : (int)blockIdx.x - g.r_tiles;
  const int p = tile * kBlock + tid;
  const bool live = record_tile ? p < e2 : (g.has_pv && p < n);
  int r = 0, e = 0, chain = 0;
  bool credit = false, pend = false, pv = false, post = false, post_grp = false;
  unsigned heads0 = S_HEAD_A | S_HEAD_B;  // past the chain's end
  u128 p_amount = 0;
  if (live && record_tile) {
    r = g.perm[p];  // tidy: range=r:0..16383 — the sort plan's perm permutes the 2n records
    credit = r >= n;
    e = credit ? r - n : r;
    heads0 = (g.head_pos[p] == p ? S_HEAD_A : 0) | (g.sub_head_pos[p] == p ? S_HEAD_B : 0);
  } else if (live) {
    e = g.f_perm[p];  // tidy: range=e:0..8191 — the sort plan's f_perm permutes the n events
    heads0 = (g.f_head_pos[p] == p ? S_HEAD_A : 0) | (g.f_sub_head_pos[p] == p ? S_HEAD_B : 0);
  }
  if (live) {
    chain = g.chain_id[e];
    uint32_t fl = g.flags[e];
    pend = fl & F_PENDING;
    pv = fl & (F_POST | F_VOID);
    post = pv && (fl & F_POST);
    post_grp = (!pend && !pv) || post;
  }
  if (live && record_tile) {
    if (g.has_pv && pv) p_amount = to_u128(g.p_amount[e]);
    if (g.external) {
      s_base[0][tid] = g.base_dp[r];
      s_base[1][tid] = g.base_dpo[r];
      s_base[2][tid] = g.base_cp[r];
      s_base[3][tid] = g.base_cpo[r];
    } else {
      int32_t slot = pv ? (credit ? g.p_cr[e] : g.p_dr[e]) : (credit ? g.cr_slot[e] : g.dr_slot[e]);
      long long sl = clip(slot, g.a);
      s_base[0][tid] = g.dp[sl];
      s_base[1][tid] = g.dpo[sl];
      s_base[2][tid] = g.cp[sl];
      s_base[3][tid] = g.cpo[sl];
    }
  }

  // Phase 0: the static ladders and the seed against the pre-batch
  // balances, no fulfillments.
  if (gid < n) {
    const int ev = (int)gid;
    event_static(g, ev);
    uint32_t c;
    u128 a;
    evaluate(g, ev, base_obs(g, ev), base_obs(g, ev + n), false, false, c, a);
    g.ok[ev] = c == 0;
    g.amt[ev] = from_u128(c == 0 ? a : 0);
    g.codes[ev] = c;
    if (g.has_chains && c != 0) atomicMax(g.cf + g.chain_id[ev], (1u << 16) | (0xFFFFu - ev));
  }
  for (long long i = gid; g.max_sweeps == 0 && i < 4ll * e2; i += nthreads) {
    g.obs[i] = make_uint4(0, 0, 0, 0);
  }
  barrier();

  // The sweeps. Sweep it reads the chain stamps it + 1 (the seed's, or the
  // last sweep's ladder) and its tiles publish under version it + 1.
  bool stable = false;
  int sweeps = 0;
  for (int it = 0; it < g.max_sweeps; ++it) {
    const unsigned ver = it + 1;
    // a. segmented sums; observed balances, in-batch fulfillments
    bool in_a = false, in_b = false;
    u128 amt = 0;
    if (live) {
      bool ok = ld(g.ok + e) != 0;
      bool cok = g.has_chains ? (ld(g.cf + chain) >> 16) != ver : ok;
      in_a = ok && cok;
      in_b = ok && !cok;
      if (record_tile) amt = to_u128(ld(g.amt + e));
    }
    bool und = false;
    if (record_tile) {
      // the record's lanes in the view its event's outcome puts it in
      Lanes<kRecLanes> v;
#pragma unroll
      for (int f = 0; f < kRecLanes; ++f) {
        u128 x = record_field(f, credit, pend, pv, post_grp, amt, p_amount);
        v.a[f] = in_a ? x : 0;
        v.b[f] = in_b ? x : 0;
      }
      scan_tile<kRecLanes>(s, g.r_status, g.r_agg, g.r_incl, tile, ver, heads0, v);
      if (live) {
        u128 d[kRecLanes];  // the exclusive sums: inclusive minus its own
#pragma unroll
        for (int f = 0; f < kRecLanes; ++f) {
          u128 x = record_field(f, credit, pend, pv, post_grp, amt, p_amount);
          // tidy: allow=limb-overflow|limb-underflow — inclusive minus own, mod 2^128 (the plain version's exclusive _seg_excl, ops/commit_exact.py:485-490): the inclusive sum holds the own term, a relation the intervals cannot carry
          d[f] = (v.a[f] - (in_a ? x : 0)) + (v.b[f] - (in_b ? x : 0));
        }
        // tidy: allow=limb-overflow — base + earlier adds, mod 2^128 as the plain version's u128.add(...)[0] (ops/commit_exact.py:492); a true balance past 2^128 overflows the posting (bail)
        u128 dp = to_u128(s_base[0][tid]) + d[0], cp = to_u128(s_base[2][tid]) + d[3];
        bool ud = dp < d[1], uc = cp < d[4];
        und = ud || uc;
        uint4* o = g.obs + 4 * (size_t)r;
        o[0] = from_u128(ud ? 0 : dp - d[1]);
        // tidy: allow=limb-overflow — base + earlier adds, mod 2^128 as the plain version's u128.add(...)[0] (ops/commit_exact.py:492); a true balance past 2^128 overflows the posting (bail)
        o[1] = from_u128(to_u128(s_base[1][tid]) + d[2]);
        o[2] = from_u128(uc ? 0 : cp - d[4]);
        // tidy: allow=limb-overflow — base + earlier adds, mod 2^128 as the plain version's u128.add(...)[0] (ops/commit_exact.py:492); a true balance past 2^128 overflows the posting (bail)
        o[3] = from_u128(to_u128(s_base[3][tid]) + d[5]);
      }
    } else if (g.has_pv) {
      Lanes<kEvLanes> v, own;
      event_lanes(v, in_a, in_b, post, pv && !post);
      scan_tile<kEvLanes>(s, g.e_status, g.e_agg, g.e_incl, tile, ver, heads0, v);
      if (live) {
        event_lanes(own, in_a, in_b, post, pv && !post);
        // tidy: allow=limb-overflow|limb-underflow — inclusive minus own, mod 2^128 (the plain version's exclusive _seg_excl, ops/commit_exact.py:485-490): the inclusive sum holds the own term, a relation the intervals cannot carry
        u128 posts = (v.a[0] - own.a[0]) + (v.b[0] - own.b[0]);
        // tidy: allow=limb-overflow|limb-underflow — inclusive minus own, mod 2^128 (the plain version's exclusive _seg_excl, ops/commit_exact.py:485-490): the inclusive sum holds the own term, a relation the intervals cannot carry
        u128 voids = (v.a[1] - own.a[1]) + (v.b[1] - own.b[1]);
        g.epv[e] = (posts != 0 ? 1u : 0u) | (voids != 0 ? 2u : 0u);
      }
    }
    if (__syncthreads_or(und) && tid == 0) atomicOr(g.ctrl + C_SWEEP + g.max_sweeps + it, 1u);
    barrier();
    // b. the dynamic ladder; stability; the chain stamps of the next sweep
    bool moved = false;
    if (gid < n) {
      const int ev = (int)gid;
      uint32_t fp = g.has_pv ? ld(g.epv + ev) : 0;
      uint32_t c;
      u128 a;
      evaluate(g, ev, load_obs(g, ev), load_obs(g, ev + n), fp & 1, fp & 2, c, a);
      bool nok = c == 0;
      u128 na = nok ? a : 0;
      moved = (nok != (ld(g.ok + ev) != 0)) || (na != to_u128(ld(g.amt + ev)));
      g.ok[ev] = nok;
      g.amt[ev] = from_u128(na);
      g.codes[ev] = c;
      if (g.has_chains && c != 0) {
        atomicMax(g.cf + g.chain_id[ev], ((ver + 1) << 16) | (0xFFFFu - ev));
      }
    }
    if (__syncthreads_or(moved) && tid == 0) atomicOr(g.ctrl + C_SWEEP + it, 1u);
    barrier();
    sweeps = it + 1;
    if (ld(g.ctrl + C_SWEEP + it) == 0) {
      stable = true;
      break;
    }
  }
  const unsigned final_stamp = sweeps + 1;

  // The posting writes the new tables: the copy must be done.
  if (!g.external) {
    if (tid == 0) {
      while (ld_acquire(g.ctrl + C_COPIED) < (unsigned)g.copy_blocks) {
      }
      __threadfence();
    }
    __syncthreads();
  }
  // Phase 3: linked-chain rollback (reference :824-833), then the adds.
  bool over = false;
  if (gid < n) {
    const int ev = (int)gid;
    uint32_t c = ld(g.codes + ev);
    if (g.has_chains) {
      // the chain's first failing event of the last sweep
      uint32_t w = ld(g.cf + g.chain_id[ev]);
      bool chain_fails = (w >> 16) == final_stamp;
      bool keep = (c != 0 && 0xFFFFu - (w & 0xFFFFu) == (uint32_t)ev) ||
                  c == LINKED_EVENT_CHAIN_OPEN;
      if (chain_fails && !keep) c = LINKED_EVENT_FAILED;
    }
    bool ok = c == 0;
    uint4 amount = ok ? ld(g.amt + ev) : make_uint4(0, 0, 0, 0);
    g.codes[ev] = c;
    g.amounts[ev] = amount;
    // post-event balances for history rows (reference :845-860)
    uint32_t bits = g.bits[ev];
    bool epv = bits & B_PV, epend = bits & B_PEND;
    u128 am = to_u128(amount);
    u128 a_pend = (ok && epend && !epv) ? am : 0;
    u128 a_post = (ok && !epend && !epv) ? am : 0;
    Obs dr = load_obs(g, ev), cr = load_obs(g, ev + n);
    // tidy: allow=limb-overflow — the post-event balance, mod 2^128 as the plain version's u128.add(...)[0] (ops/commit_exact.py:630-637); past 2^128 the posting overflows (:617) and the batch bails
    g.dr_dp[ev] = from_u128(dr.dp + a_pend);
    // tidy: allow=limb-overflow — the post-event balance, mod 2^128 as the plain version's u128.add(...)[0] (ops/commit_exact.py:630-637); past 2^128 the posting overflows (:617) and the batch bails
    g.dr_dpo[ev] = from_u128(dr.dpo + a_post);
    g.dr_cp[ev] = from_u128(dr.cp);
    g.dr_cpo[ev] = from_u128(dr.cpo);
    g.cr_dp[ev] = from_u128(cr.dp);
    g.cr_dpo[ev] = from_u128(cr.dpo);
    // tidy: allow=limb-overflow — the post-event balance, mod 2^128 as the plain version's u128.add(...)[0] (ops/commit_exact.py:630-637); past 2^128 the posting overflows (:617) and the batch bails
    g.cr_cp[ev] = from_u128(cr.cp + a_pend);
    // tidy: allow=limb-overflow — the post-event balance, mod 2^128 as the plain version's u128.add(...)[0] (ops/commit_exact.py:630-637); past 2^128 the posting overflows (:617) and the batch bails
    g.cr_cpo[ev] = from_u128(cr.cpo + a_post);
    if (g.external) {
      // _apply's masks (reference :866-874) for the shards to post
      bool epost = epv && (bits & B_POST);
      g.out_eff_dr[ev] = g.eff_dr[ev];
      g.out_eff_cr[ev] = g.eff_cr[ev];
      g.out_mask[ev] = (ok && epend && !epv ? M_ADD_PEND : 0) |
                       (ok && ((!epend && !epv) || epost) ? M_ADD_POST : 0) |
                       (ok && epv ? M_SUB_PEND : 0);
    } else if (ok && !(epv && !(bits & B_POST))) {
      // _apply's adds (reference :882-885)
      bool to_pend = epend && !epv;
      post_row(g, to_pend ? g.ndp : g.ndpo, g.eff_dr[ev], amount, false, over);
      post_row(g, to_pend ? g.ncp : g.ncpo, g.eff_cr[ev], amount, false, over);
    }
  }
  barrier();
  // Phase 4: the pending removals of post/void (reference :886-887).
  if (!g.external && gid < n) {
    const int ev = (int)gid;
    if ((g.bits[ev] & B_PV) && ld(g.codes + ev) == 0) {
      uint4 pa = g.p_amount[ev];
      post_row(g, g.ndp, g.eff_dr[ev], pa, true, over);
      post_row(g, g.ncp, g.eff_cr[ev], pa, true, over);
    }
  }
  barrier();
  // Phase 5: pending + posted of the touched rows, or of all rows
  // (reference :888-889).
  if (g.external) {
    // the shards check their own rows (sharded_apply.cu)
  } else if (ld(g.ctrl + C_OLD_OVER)) {
    // four rows a step, so the sweep blocks alone keep as many loads in
    // flight as the whole grid would with one
    for (long long row = gid; row < g.a; row += 4 * nthreads) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        long long r = row + k * nthreads;
        if (r < g.a) over |= row_overflows(g.ndp, g.ndpo, g.ncp, g.ncpo, r);
      }
    }
  } else if (gid < n && ld(g.codes + gid) == 0) {
    long long rows[2] = {scatter_row(g.eff_dr[gid], g.a), scatter_row(g.eff_cr[gid], g.a)};
    for (int k = 0; k < 2; ++k) {
      if (rows[k] >= 0) over |= row_overflows(g.ndp, g.ndpo, g.ncp, g.ncpo, rows[k]);
    }
  }
  // The last sweep block to finish writes bail.
  bool any = __syncthreads_or(over);
  if (tid == 0) {
    if (any) atomicOr(g.ctrl + C_OVER, 1u);
    __threadfence();
    if (atomicAdd(g.ctrl + C_FINISHED, 1u) == (unsigned)sweep_blocks - 1) {
      __threadfence();  // every block's flags before its count
      bool under_final =
          sweeps > 0 && ld_acquire(g.ctrl + C_SWEEP + g.max_sweeps + sweeps - 1) != 0;
      *g.bail = !stable || ld_acquire(g.ctrl + C_OVER) != 0 || under_final;
      atomicAdd(g.sweep_stats, (unsigned long long)sweeps);
      atomicAdd(g.sweep_stats + 1, 1ull);
      atomicMax(g.sweep_stats + 2, (unsigned long long)sweeps);
    }
  }
}

// Per device: SMs and resident blocks an SM, queried once.
struct DeviceInfo {
  bool ready;
  int sms, per_sm;
};
DeviceInfo g_device[64];

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
  if (n < 1 || 2 * n > 16384 || max_sweeps < 0 || max_sweeps > 0xFFFE || a < 1 ||
      a > 0x7FFFFFFF)
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
  g.epv = (uint32_t*)(scratch + lay.epv);
  g.obs = (uint4*)(scratch + lay.obs);
  g.r_agg = (uint4*)(scratch + lay.r_agg);
  g.r_incl = (uint4*)(scratch + lay.r_incl);
  g.e_agg = (uint4*)(scratch + lay.e_agg);
  g.e_incl = (uint4*)(scratch + lay.e_incl);
  g.ctrl = (uint32_t*)(scratch + lay.ctrl);
  g.cf = (uint32_t*)(scratch + lay.cf);
  g.r_status = (uint32_t*)(scratch + lay.r_status);
  g.e_status = (uint32_t*)(scratch + lay.e_status);
  g.a = a;
  g.n = (int)n;
  g.max_sweeps = (int)max_sweeps;
  g.r_tiles = tiles_of(2 * n);
  g.e_tiles = tiles_of(n);
  g.has_pv = dims[3] != 0;
  g.has_chains = dims[4] != 0;

  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  DeviceInfo& info = g_device[dev];
  if (!info.ready) {
    err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info.per_sm, exact_kernel, kBlock, 0);
    if (err != cudaSuccess) return (int)err;
    info.ready = true;
  }
  const int sweep_blocks = g.r_tiles + g.e_tiles;
  const int resident = info.sms * (info.per_sm < 2 ? info.per_sm : 2);
  // the sweep blocks and, unless external, at least one copy block
  if (resident < sweep_blocks + (g.external ? 0 : 1))
    return (int)cudaErrorCooperativeLaunchTooLarge;
  g.copy_blocks = g.external ? 0 : resident - sweep_blocks;

  err = cudaMemsetAsync(scratch + lay.ctrl, 0, lay.end - lay.ctrl, s);
  if (err != cudaSuccess) return (int)err;
  void* kargs[] = {&g};
  err = cudaLaunchCooperativeKernel((const void*)exact_kernel, dim3(sweep_blocks + g.copy_blocks),
                                    dim3(kBlock), kargs, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
