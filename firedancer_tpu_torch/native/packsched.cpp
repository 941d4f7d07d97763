// Native pack scheduler hot loop (ballet/pack.py's native path).
//
// The reference fd_pack shape reduced to a flat-C state machine: a
// fixed-capacity slot pool, a binary max-heap ordered by (priority desc,
// seq asc), the exact total order of the Python (-prio, seq) heapq
// tuples; account locks as 256-bit bloom bitsets (two splitmix64-derived
// bits per account, so the conflict check is four word ANDs per side);
// and an open-addressed u64-key table for the consensus per-account
// write budget.
//
// The port's own copy of firedancer_tpu/native/packsched.cpp, the same
// code.  Bit-identity contract with the Python scheduler (tests enforce
// it):
//  * priority is computed host-side (arbitrary-precision reward math) and
//    passed in saturated to u64; C never re-derives it.
//  * fd_pack_acct_key == ballet.pack.acct_key for every 32-byte address.
//  * the schedule loop applies the same checks in the same order with the
//    same break/continue distinctions (block-cost overflow STOPS the
//    microblock; vote/data/conflict/budget failures only defer that txn).
//
// C ABI (ctypes): opaque handle + flat scalars; chosen txns are returned
// as slot indices the Python side maps back to held payloads.

#include <cstdint>
#include <cstdlib>
#include <cstring>

#define API extern "C" __attribute__((visibility("default")))

namespace {

// consensus limits — keep in lockstep with ballet/pack.py
constexpr uint64_t MAX_COST_PER_BLOCK = 48000000ull;
constexpr uint64_t MAX_VOTE_COST_PER_BLOCK = 36000000ull;
constexpr uint64_t MAX_WRITE_COST_PER_ACCT = 12000000ull;
constexpr uint64_t MAX_DATA_PER_BLOCK =
    ((32ull * 1024ull - 17ull) / 31ull) * 25871ull + 48ull;

constexpr int MAX_BANKS = 64;

struct Slot {
  uint64_t cost;
  uint64_t prio;
  uint64_t seq;
  uint64_t wmask[4];
  uint64_t rmask[4];
  uint64_t *wkeys;  // unique writable account keys (malloc'd per insert)
  int32_t n_wkeys;
  int32_t payload_len;
  uint8_t is_vote;
  uint8_t used;
};

struct Pack {
  int bank_cnt;
  int64_t pool_cap;   // hard bound
  int64_t alloc_cap;  // currently allocated slots (doubles on demand)
  Slot *slots;
  int64_t *freelist;  // stack of RELEASED slots only
  int64_t free_cnt;
  int64_t next_fresh;  // high-water mark: slots >= this were never used
  int64_t *heap;  // slot indices, max-heap by (prio desc, seq asc)
  int64_t heap_cnt;
  int64_t *skipped;  // scratch for deferred pops
  uint64_t bank_w[MAX_BANKS][4];
  uint64_t bank_r[MAX_BANKS][4];
  uint64_t gw[4];   // cached union of in-flight writable masks
  uint64_t grw[4];  // cached union of in-flight writable|readonly masks
  uint64_t block_cost, block_vote, block_data;
  // open-addressed per-account write cost table (cleared per block)
  uint64_t *tk;
  uint64_t *tv;
  uint8_t *tu;
  int64_t tcap, tcnt;
};

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

inline uint64_t acct_key(uint8_t const *a) {
  // distinct odd multipliers per limb: a plain xor-fold cancels on
  // repeated limb patterns (e.g. a byte repeated 32 times)
  uint64_t l[4];
  std::memcpy(l, a, 32);
  return splitmix64((l[0] * 0x9E3779B97F4A7C15ull)
                    ^ (l[1] * 0xC2B2AE3D27D4EB4Full)
                    ^ (l[2] * 0x165667B19E3779F9ull)
                    ^ (l[3] * 0x27D4EB2F165667C5ull));
}

inline void mask_set(uint64_t m[4], uint64_t key) {
  unsigned b0 = (unsigned)(key & 255u);
  unsigned b1 = (unsigned)((key >> 8) & 255u);
  m[b0 >> 6] |= 1ull << (b0 & 63u);
  m[b1 >> 6] |= 1ull << (b1 & 63u);
}

inline int mask_intersects(uint64_t const a[4], uint64_t const b[4]) {
  return ((a[0] & b[0]) | (a[1] & b[1]) | (a[2] & b[2]) | (a[3] & b[3]))
         != 0ull;
}

inline void mask_or(uint64_t d[4], uint64_t const s[4]) {
  d[0] |= s[0]; d[1] |= s[1]; d[2] |= s[2]; d[3] |= s[3];
}

// heap order: "less" == should pop first
inline int heap_before(Pack *p, int64_t a, int64_t b) {
  Slot const &sa = p->slots[a], &sb = p->slots[b];
  if (sa.prio != sb.prio) return sa.prio > sb.prio;
  return sa.seq < sb.seq;
}

void heap_push(Pack *p, int64_t idx) {
  int64_t i = p->heap_cnt++;
  p->heap[i] = idx;
  while (i > 0) {
    int64_t par = (i - 1) >> 1;
    if (!heap_before(p, p->heap[i], p->heap[par])) break;
    int64_t t = p->heap[i]; p->heap[i] = p->heap[par]; p->heap[par] = t;
    i = par;
  }
}

int64_t heap_pop(Pack *p) {
  int64_t top = p->heap[0];
  int64_t n = --p->heap_cnt;
  if (n > 0) {
    p->heap[0] = p->heap[n];
    int64_t i = 0;
    for (;;) {
      int64_t l = 2 * i + 1, r = l + 1, best = i;
      if (l < n && heap_before(p, p->heap[l], p->heap[best])) best = l;
      if (r < n && heap_before(p, p->heap[r], p->heap[best])) best = r;
      if (best == i) break;
      int64_t t = p->heap[i]; p->heap[i] = p->heap[best];
      p->heap[best] = t;
      i = best;
    }
  }
  return top;
}

// per-account write-cost table -------------------------------------------
uint64_t tbl_get(Pack *p, uint64_t key) {
  int64_t mask = p->tcap - 1;
  int64_t i = (int64_t)(key & (uint64_t)mask);
  while (p->tu[i]) {
    if (p->tk[i] == key) return p->tv[i];
    i = (i + 1) & mask;
  }
  return 0;
}

void tbl_grow(Pack *p);

void tbl_add(Pack *p, uint64_t key, uint64_t add) {
  if (4 * (p->tcnt + 1) >= 3 * p->tcap) tbl_grow(p);
  int64_t mask = p->tcap - 1;
  int64_t i = (int64_t)(key & (uint64_t)mask);
  while (p->tu[i]) {
    if (p->tk[i] == key) { p->tv[i] += add; return; }
    i = (i + 1) & mask;
  }
  p->tu[i] = 1; p->tk[i] = key; p->tv[i] = add; p->tcnt++;
}

void tbl_grow(Pack *p) {
  int64_t ncap = p->tcap * 2;
  uint64_t *nk = (uint64_t *)std::calloc((size_t)ncap, 8);
  uint64_t *nv = (uint64_t *)std::calloc((size_t)ncap, 8);
  uint8_t *nu = (uint8_t *)std::calloc((size_t)ncap, 1);
  int64_t nmask = ncap - 1;
  for (int64_t i = 0; i < p->tcap; i++) {
    if (!p->tu[i]) continue;
    int64_t j = (int64_t)(p->tk[i] & (uint64_t)nmask);
    while (nu[j]) j = (j + 1) & nmask;
    nu[j] = 1; nk[j] = p->tk[i]; nv[j] = p->tv[i];
  }
  std::free(p->tk); std::free(p->tv); std::free(p->tu);
  p->tk = nk; p->tv = nv; p->tu = nu; p->tcap = ncap;
}

void slot_release(Pack *p, int64_t idx) {
  Slot &s = p->slots[idx];
  std::free(s.wkeys);
  s.wkeys = nullptr;
  s.n_wkeys = 0;
  s.used = 0;
  p->freelist[p->free_cnt++] = idx;
}

}  // namespace

API void *fd_pack_new(int bank_cnt, long long pool_cap) {
  if (bank_cnt < 1 || bank_cnt > MAX_BANKS || pool_cap < 1) return nullptr;
  Pack *p = (Pack *)std::calloc(1, sizeof(Pack));
  if (!p) return nullptr;
  p->bank_cnt = bank_cnt;
  p->pool_cap = pool_cap;
  // start small and double on demand: construction stays O(1 KB) even
  // with a 64K hard cap (a fresh Pack per bench rep / tile respawn must
  // not pay megabytes of calloc)
  p->alloc_cap = pool_cap < 1024 ? pool_cap : 1024;
  p->slots = (Slot *)std::calloc((size_t)p->alloc_cap, sizeof(Slot));
  p->freelist = (int64_t *)std::malloc((size_t)p->alloc_cap * 8);
  p->heap = (int64_t *)std::malloc((size_t)p->alloc_cap * 8);
  p->skipped = (int64_t *)std::malloc((size_t)p->alloc_cap * 8);
  p->tcap = 1024;
  p->tk = (uint64_t *)std::calloc((size_t)p->tcap, 8);
  p->tv = (uint64_t *)std::calloc((size_t)p->tcap, 8);
  p->tu = (uint8_t *)std::calloc((size_t)p->tcap, 1);
  if (!p->slots || !p->freelist || !p->heap || !p->skipped || !p->tk ||
      !p->tv || !p->tu) {
    std::free(p->slots); std::free(p->freelist); std::free(p->heap);
    std::free(p->skipped); std::free(p->tk); std::free(p->tv);
    std::free(p->tu); std::free(p);
    return nullptr;
  }
  // slots are handed out lazily (released ones first, then fresh off the
  // high-water mark) so construction and teardown never touch the whole
  // pool — slot idx never affects schedule order (the heap orders by
  // prio/seq), so allocation order is free
  return p;
}

API void fd_pack_delete(void *h) {
  if (!h) return;
  Pack *p = (Pack *)h;
  for (int64_t i = 0; i < p->next_fresh; i++)
    if (p->slots[i].used) std::free(p->slots[i].wkeys);
  std::free(p->slots); std::free(p->freelist); std::free(p->heap);
  std::free(p->skipped); std::free(p->tk); std::free(p->tv);
  std::free(p->tu); std::free(p);
}

API unsigned long long fd_pack_acct_key(const unsigned char *addr) {
  return acct_key(addr);
}

// args: one packed little-endian blob (struct "<IIIIIIIQQQ", 52 bytes):
// acct_addr_off, n_acct, sig_cnt, ro_signed, ro_unsigned, is_vote,
// payload_len, cost, prio, seq.  One blob instead of 12 scalars keeps
// the ctypes marshalling cost at ~3 conversions per insert.
API long long fd_pack_insert(void *h, const unsigned char *payload,
                             const unsigned char *args) {
  uint32_t w[7];
  uint64_t q[3];
  std::memcpy(w, args, 28);
  std::memcpy(q, args + 28, 24);
  int acct_addr_off = (int)w[0], n_acct = (int)w[1], sig_cnt = (int)w[2];
  int ro_signed = (int)w[3], ro_unsigned = (int)w[4];
  int is_vote = (int)w[5], payload_len = (int)w[6];
  uint64_t cost = q[0], prio = q[1], seq = q[2];
  Pack *p = (Pack *)h;
  int64_t idx;
  if (p->free_cnt > 0) {
    idx = p->freelist[--p->free_cnt];
  } else if (p->next_fresh < p->alloc_cap) {
    idx = p->next_fresh++;
  } else if (p->alloc_cap < p->pool_cap) {
    int64_t ncap = p->alloc_cap * 2;
    if (ncap > p->pool_cap) ncap = p->pool_cap;
    Slot *ns = (Slot *)std::realloc(p->slots, (size_t)ncap * sizeof(Slot));
    if (!ns) return -1;
    p->slots = ns;
    int64_t *nf = (int64_t *)std::realloc(p->freelist, (size_t)ncap * 8);
    if (!nf) return -1;
    p->freelist = nf;
    int64_t *nh = (int64_t *)std::realloc(p->heap, (size_t)ncap * 8);
    if (!nh) return -1;
    p->heap = nh;
    int64_t *nk = (int64_t *)std::realloc(p->skipped, (size_t)ncap * 8);
    if (!nk) return -1;
    p->skipped = nk;
    p->alloc_cap = ncap;
    idx = p->next_fresh++;
  } else {
    return -1;
  }
  Slot &s = p->slots[idx];
  std::memset(s.wmask, 0, 32);
  std::memset(s.rmask, 0, 32);
  s.cost = cost;
  s.prio = prio;
  s.seq = seq;
  s.payload_len = payload_len;
  s.is_vote = (uint8_t)(is_vote != 0);
  s.used = 1;
  s.wkeys = n_acct > 0 ? (uint64_t *)std::malloc((size_t)n_acct * 8)
                       : nullptr;
  s.n_wkeys = 0;
  // fd_txn.h account ordering: writability from four header counts
  int w_signed_end = sig_cnt - ro_signed;
  int w_unsigned_end = n_acct - ro_unsigned;
  for (int i = 0; i < n_acct; i++) {
    uint64_t k = acct_key(payload + acct_addr_off + 32 * i);
    int writable =
        (i < sig_cnt) ? (i < w_signed_end) : (i < w_unsigned_end);
    if (writable) {
      mask_set(s.wmask, k);
      int dup = 0;
      for (int j = 0; j < s.n_wkeys; j++)
        if (s.wkeys[j] == k) { dup = 1; break; }
      if (!dup) s.wkeys[s.n_wkeys++] = k;
    } else {
      mask_set(s.rmask, k);
    }
  }
  heap_push(p, idx);
  return idx;
}

API long long fd_pack_pending(void *h) { return ((Pack *)h)->heap_cnt; }

API void fd_pack_clear_pending(void *h) {
  Pack *p = (Pack *)h;
  for (int64_t i = 0; i < p->heap_cnt; i++) slot_release(p, p->heap[i]);
  p->heap_cnt = 0;
}

API long long fd_pack_schedule(void *h, int bank, int max_txn,
                               long long *out_idx, long long *delayed_out) {
  Pack *p = (Pack *)h;
  uint64_t w_busy[4], rw_busy[4];
  std::memcpy(w_busy, p->gw, 32);
  std::memcpy(rw_busy, p->grw, 32);
  int64_t n_chosen = 0, n_skipped = 0, delayed = 0;
  uint64_t mb_cost = 0, mb_vote = 0, mb_data = 0;
  while (p->heap_cnt > 0 && n_chosen < max_txn) {
    int64_t idx = heap_pop(p);
    Slot &s = p->slots[idx];
    uint64_t c = s.cost;
    if (p->block_cost + mb_cost + c > MAX_COST_PER_BLOCK) {
      p->skipped[n_skipped++] = idx;
      break;
    }
    if (s.is_vote &&
        p->block_vote + mb_vote + c > MAX_VOTE_COST_PER_BLOCK) {
      p->skipped[n_skipped++] = idx;
      continue;
    }
    if (p->block_data + mb_data + (uint64_t)s.payload_len
        > MAX_DATA_PER_BLOCK) {
      p->skipped[n_skipped++] = idx;
      continue;
    }
    if (mask_intersects(s.wmask, rw_busy) ||
        mask_intersects(s.rmask, w_busy)) {
      delayed++;
      p->skipped[n_skipped++] = idx;
      continue;
    }
    int over = 0;
    for (int j = 0; j < s.n_wkeys; j++)
      if (tbl_get(p, s.wkeys[j]) + c > MAX_WRITE_COST_PER_ACCT) {
        over = 1;
        break;
      }
    if (over) {
      p->skipped[n_skipped++] = idx;
      continue;
    }
    // accept: intra-microblock conflicts are excluded immediately
    out_idx[n_chosen++] = idx;
    mb_cost += c;
    if (s.is_vote) mb_vote += c;
    mb_data += (uint64_t)s.payload_len;
    mask_or(w_busy, s.wmask);
    mask_or(rw_busy, s.wmask);
    mask_or(rw_busy, s.rmask);
  }
  for (int64_t i = 0; i < n_skipped; i++) heap_push(p, p->skipped[i]);
  *delayed_out = delayed;
  if (n_chosen == 0) return 0;
  for (int64_t i = 0; i < n_chosen; i++) {
    Slot &s = p->slots[out_idx[i]];
    mask_or(p->bank_w[bank], s.wmask);
    mask_or(p->bank_r[bank], s.rmask);
    for (int j = 0; j < s.n_wkeys; j++) tbl_add(p, s.wkeys[j], s.cost);
  }
  mask_or(p->gw, p->bank_w[bank]);
  mask_or(p->grw, p->bank_w[bank]);
  mask_or(p->grw, p->bank_r[bank]);
  p->block_cost += mb_cost;
  p->block_vote += mb_vote;
  p->block_data += mb_data;
  // release the chosen slots (wkeys already folded into the budget
  // table); out_idx keeps the indices for the Python _slots map
  for (int64_t i = 0; i < n_chosen; i++) slot_release(p, out_idx[i]);
  return n_chosen;
}

API void fd_pack_done(void *h, int bank) {
  Pack *p = (Pack *)h;
  std::memset(p->bank_w[bank], 0, 32);
  std::memset(p->bank_r[bank], 0, 32);
  // bloom bits are shared, so refold the surviving banks (O(banks) words)
  std::memset(p->gw, 0, 32);
  std::memset(p->grw, 0, 32);
  for (int b = 0; b < p->bank_cnt; b++) {
    mask_or(p->gw, p->bank_w[b]);
    mask_or(p->grw, p->bank_w[b]);
    mask_or(p->grw, p->bank_r[b]);
  }
}

API void fd_pack_end_block(void *h) {
  Pack *p = (Pack *)h;
  p->block_cost = 0;
  p->block_vote = 0;
  p->block_data = 0;
  std::memset(p->tu, 0, (size_t)p->tcap);
  p->tcnt = 0;
}
