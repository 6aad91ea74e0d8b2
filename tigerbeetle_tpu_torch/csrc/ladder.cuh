// The fast route's validation ladder for one event, shared by
// create_transfers_fast.cu and sharded_validate.cu (one copy of the rungs).
//
// The port of the reference package's ops/commit.py validate_simple (:127)
// and merge_codes (:104): the rungs in upstream precedence order
// (state_machine.zig:1239-1368), then the nonzero minimum with the host's
// code.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tb {
namespace fast {

// TransferFlags bits (flags.py; upstream tigerbeetle.zig:107-120).
constexpr uint32_t F_LINKED = 1u << 0;
constexpr uint32_t F_PENDING = 1u << 1;
constexpr uint32_t F_POST = 1u << 2;
constexpr uint32_t F_VOID = 1u << 3;
constexpr uint32_t F_BAL_DR = 1u << 4;
constexpr uint32_t F_BAL_CR = 1u << 5;
constexpr uint32_t F_PADDING = 0xFFFFu & ~0x3Fu;
constexpr uint32_t F_UNSUPPORTED = F_LINKED | F_POST | F_VOID | F_BAL_DR | F_BAL_CR;

// CreateTransferResult codes (results.py, the wire contract; ops/commit.py
// asserts these against the enum).
constexpr uint32_t RESERVED_FLAG = 4;
constexpr uint32_t ID_MUST_NOT_BE_ZERO = 5;
constexpr uint32_t ID_MUST_NOT_BE_INT_MAX = 6;
constexpr uint32_t PENDING_ID_MUST_BE_ZERO = 13;
constexpr uint32_t TIMEOUT_RESERVED_FOR_PENDING_TRANSFER = 17;
constexpr uint32_t AMOUNT_MUST_NOT_BE_ZERO = 18;
constexpr uint32_t LEDGER_MUST_NOT_BE_ZERO = 19;
constexpr uint32_t CODE_MUST_NOT_BE_ZERO = 20;
constexpr uint32_t DEBIT_ACCOUNT_NOT_FOUND = 21;
constexpr uint32_t CREDIT_ACCOUNT_NOT_FOUND = 22;
constexpr uint32_t ACCOUNTS_MUST_HAVE_THE_SAME_LEDGER = 23;
constexpr uint32_t TRANSFER_MUST_HAVE_THE_SAME_LEDGER_AS_ACCOUNTS = 24;
constexpr uint32_t OVERFLOWS_TIMEOUT = 53;

constexpr unsigned long long NS_PER_S = 1000000000ull;

struct Batch {
  const uint4* id;
  const int32_t* dr_slot;
  const int32_t* cr_slot;
  const uint4* amount;
  const uint4* pending_id;
  const uint32_t* timeout;
  const uint32_t* ledger;
  const uint32_t* code;
  const uint32_t* flags;
  const uint2* timestamp;
  const uint32_t* host_code;
};

__device__ __forceinline__ bool is_zero(uint4 v) {
  return (v.x | v.y | v.z | v.w) == 0;
}

__device__ __forceinline__ bool is_max(uint4 v) {
  return (v.x & v.y & v.z & v.w) == 0xFFFFFFFFu;
}

// The reference's ladder (validate_simple) for event i, then merge_codes.
// tidy: range=i:0..0x7FFFFFFF,a:1..0x7FFFFFFF — an event of a batch below 2^31; A rows, addressed by int32 slots
__device__ __forceinline__ uint32_t ladder(const Batch& b, long long i,
                                           const uint32_t* acc_ledger,
                                           long long a) {
  uint32_t flags = b.flags[i];
  bool pend = (flags & F_PENDING) != 0;
  uint4 id = b.id[i];
  int32_t dr = b.dr_slot[i], cr = b.cr_slot[i];
  uint32_t code = 0;
  if (flags & F_PADDING) code = RESERVED_FLAG;
  else if (is_zero(id)) code = ID_MUST_NOT_BE_ZERO;
  else if (is_max(id)) code = ID_MUST_NOT_BE_INT_MAX;
  else if (!is_zero(b.pending_id[i])) code = PENDING_ID_MUST_BE_ZERO;
  else if (!pend && b.timeout[i] != 0) code = TIMEOUT_RESERVED_FOR_PENDING_TRANSFER;
  else if (is_zero(b.amount[i])) code = AMOUNT_MUST_NOT_BE_ZERO;
  else if (b.ledger[i] == 0) code = LEDGER_MUST_NOT_BE_ZERO;
  else if (b.code[i] == 0) code = CODE_MUST_NOT_BE_ZERO;
  else if (dr < 0) code = DEBIT_ACCOUNT_NOT_FOUND;
  else if (cr < 0) code = CREDIT_ACCOUNT_NOT_FOUND;
  else {
    // Slots clipped to [0, A-1] as the reference's gather does.
    uint32_t dr_ledger = acc_ledger[dr < a ? dr : a - 1];
    uint32_t cr_ledger = acc_ledger[cr < a ? cr : a - 1];
    uint2 ts = b.timestamp[i];
    unsigned long long t = ((unsigned long long)ts.y << 32) | ts.x;
    unsigned long long timeout_ns = (unsigned long long)b.timeout[i] * NS_PER_S;
    if (dr_ledger != cr_ledger) code = ACCOUNTS_MUST_HAVE_THE_SAME_LEDGER;
    else if (b.ledger[i] != dr_ledger)
      code = TRANSFER_MUST_HAVE_THE_SAME_LEDGER_AS_ACCOUNTS;
    // timeout_ns < 2^32 * 10^9 < 2^64 (proven); the sum's wrap is the test.
    else if (t + timeout_ns < t) code = OVERFLOWS_TIMEOUT;  // tidy: allow=limb-overflow
  }
  // Nonzero minimum with the host's code (results are ordered by
  // precedence, and both sides emit their first failing rung).
  uint32_t host = b.host_code[i];
  if (code == 0 || (host != 0 && host < code)) code = host;
  return code;
}

// An OK event of a supported kind posts; its slots are then >= 0 (the
// ladder's not-found rungs), and a slot >= A is dropped by the callers, as
// the reference's mode="drop" scatter drops it.
// tidy: range=i:0..0x7FFFFFFF — an event of a batch below 2^31
__device__ __forceinline__ bool posts(const Batch& b, long long i,
                                      uint32_t code) {
  return code == 0 && (b.flags[i] & F_UNSUPPORTED) == 0;
}

}  // namespace fast
}  // namespace tb
