// Batch transaction parser + dedup tcache: the verify tile's host data
// plane in native code.
//
// One C call a burst does what the scalar path does a txn at a time:
// parse every payload with fd_txn_parse's validation rules (ref
// src/ballet/txn/fd_txn_parse.c:80-236), query a tcache on the
// first-signature tag (ref src/tango/tcache/fd_tcache.h query/insert
// macros), and scatter message/signature/pubkey bytes straight into the
// verify bucket's packed rows.
//
// The port's own copy of firedancer_tpu/native/txnparse.cpp, the same
// code.  Validation is rule-identical to ballet/txn.py parse;
// tests/test_torch_txn_native.py diffs the two parsers over a corpus and
// mutation fuzz.
//
// C ABI (ctypes): flat arrays only.

#include <cstdint>
#include <cstdlib>
#include <cstring>

#define API extern "C" __attribute__((visibility("default")))

namespace {

// wire limits (ref src/ballet/txn/fd_txn.h:35-108)
constexpr int kSigSz = 64;
constexpr int kPubSz = 32;
constexpr int kBlockhashSz = 32;
constexpr int kSigMax = 127;
constexpr int kAcctMax = 128;
constexpr int kAddrLutMax = 127;
constexpr int kInstrMax = 64;
constexpr int kMtu = 1232;

// error codes (txn_err out array)
enum {
  kOk = 0,
  kErrParse = 1,    // any fd_txn_parse rule violation
  kErrTooLong = 2,  // message exceeds this bucket's maxlen (reroute)
  kErrDup = 3,      // tcache hit on first-sig tag
  kErrSigCap = 4,   // more sig lanes than one batch holds
};

struct Cursor {
  const uint8_t *p;
  int n;
  int i = 0;
  bool fail = false;

  bool need(int k) {
    if (k > n - i) fail = true;
    return !fail;
  }
  uint8_t u8() {
    if (!need(1)) return 0;
    return p[i++];
  }
  // compact-u16 varint (ref src/ballet/txn/fd_compact_u16.h): 1-3 bytes,
  // canonical encoding required (no overlong forms)
  int cu16() {
    if (!need(1)) return -1;
    uint32_t b0 = p[i++];
    if (!(b0 & 0x80)) return (int)b0;
    if (!need(1)) return -1;
    uint32_t b1 = p[i++];
    if (!(b1 & 0x80)) {
      if (b1 == 0) { fail = true; return -1; }  // overlong
      return (int)((b0 & 0x7F) | (b1 << 7));
    }
    if (!need(1)) return -1;
    uint32_t b2 = p[i++];
    if (b2 > 3 || b2 == 0) { fail = true; return -1; }  // >16 bits / overlong
    return (int)((b0 & 0x7F) | ((b1 & 0x7F) << 7) | (b2 << 14));
  }
};

// ------------------------------------------------------------------ tcache
// Open-addressed map + eviction ring, the fd_tcache contract: remembers
// the most recent `depth` distinct tags; query hits iff the tag is in the
// window.  Insert evicts the oldest ring entry from the map.

struct Tcache {
  uint64_t depth;
  uint64_t map_cnt;   // power of two, > 2*depth
  uint64_t ring_head; // next ring slot to overwrite
  uint64_t used;      // ring entries filled so far (< depth while warming)
  uint64_t *ring;     // (depth,)
  uint64_t *map;      // (map_cnt,) 0 = empty (tag 0 is mapped to 1)
};

inline uint64_t tag_hash(uint64_t t) {
  // fmix64 (splitmix finalizer) — same avalanche role as fd_tcache's
  // multiplicative hash
  t ^= t >> 33;
  t *= 0xFF51AFD7ED558CCDULL;
  t ^= t >> 33;
  t *= 0xC4CEB9FE1A85EC53ULL;
  t ^= t >> 33;
  return t;
}

// tag 0 is the null tag: never cached, never a hit (same contract as
// tango/tcache.py — callers with a real zero tag must remap it themselves)
bool tc_query(const Tcache *tc, uint64_t tag) {
  if (!tag) return false;
  uint64_t mask = tc->map_cnt - 1;
  uint64_t s = tag_hash(tag) & mask;
  while (tc->map[s]) {
    if (tc->map[s] == tag) return true;
    s = (s + 1) & mask;
  }
  return false;
}

void tc_map_remove(Tcache *tc, uint64_t tag) {
  // Robin-hood-free deletion with backward-shift (keeps probe chains
  // intact without tombstones)
  uint64_t mask = tc->map_cnt - 1;
  uint64_t s = tag_hash(tag) & mask;
  while (tc->map[s] && tc->map[s] != tag) s = (s + 1) & mask;
  if (!tc->map[s]) return;
  uint64_t hole = s;
  uint64_t j = s;
  for (;;) {
    j = (j + 1) & mask;
    uint64_t t = tc->map[j];
    if (!t) break;
    uint64_t home = tag_hash(t) & mask;
    // can t move into the hole?  yes iff hole is cyclically within
    // [home, j)
    uint64_t d_hole = (hole - home) & mask;
    uint64_t d_j = (j - home) & mask;
    if (d_hole <= d_j) {
      tc->map[hole] = t;
      hole = j;
    }
  }
  tc->map[hole] = 0;
}

void tc_insert(Tcache *tc, uint64_t tag) {
  if (!tag) return;
  if (tc_query(tc, tag)) return;
  if (tc->used == tc->depth) {
    tc_map_remove(tc, tc->ring[tc->ring_head]);
  } else {
    tc->used++;
  }
  tc->ring[tc->ring_head] = tag;
  tc->ring_head = (tc->ring_head + 1) % tc->depth;
  uint64_t mask = tc->map_cnt - 1;
  uint64_t s = tag_hash(tag) & mask;
  while (tc->map[s]) s = (s + 1) & mask;
  tc->map[s] = tag;
}

}  // namespace

API void *fd_tcache_new(uint64_t depth) {
  uint64_t map_cnt = 1;
  while (map_cnt < 4 * depth) map_cnt <<= 1;
  Tcache *tc = new Tcache();
  tc->depth = depth;
  tc->map_cnt = map_cnt;
  tc->ring_head = 0;
  tc->used = 0;
  tc->ring = (uint64_t *)calloc(depth, 8);
  tc->map = (uint64_t *)calloc(map_cnt, 8);
  // Pre-fault both regions NOW: calloc maps lazily, so without this every
  // first-touch slot in the (randomly probed) map costs a page fault IN
  // THE HOT PATH — ~2 us each, dominating query/insert until the whole
  // map has been walked (measured ~3 us/txn of fault cost on a cold
  // depth 2^21 tcache).  Same move as the reference's pre-touched
  // workspace pages (fd_wksp): pay the commit at creation, keep the
  // steady state fault-free.  volatile stores, one per 4 KiB page —
  // a plain memset(0) after calloc is dead-store-eliminated (calloc
  // already guarantees zeros) and faults nothing.
  constexpr uint64_t kPerPage = 4096 / 8;
  volatile uint64_t *vr = tc->ring;
  for (uint64_t i = 0; i < depth; i += kPerPage) vr[i] = 0;
  volatile uint64_t *vm = tc->map;
  for (uint64_t i = 0; i < map_cnt; i += kPerPage) vm[i] = 0;
  return tc;
}

API void fd_tcache_delete(void *h) {
  Tcache *tc = (Tcache *)h;
  free(tc->ring);
  free(tc->map);
  delete tc;
}

API int fd_tcache_query(void *h, uint64_t tag) {
  return tc_query((Tcache *)h, tag) ? 1 : 0;
}

API void fd_tcache_insert(void *h, uint64_t tag) {
  tc_insert((Tcache *)h, tag);
}

API void fd_tcache_insert_batch(void *h, const uint64_t *tags, int n) {
  Tcache *tc = (Tcache *)h;
  for (int i = 0; i < n; i++) tc_insert(tc, tags[i]);
}

// Batched FD_TCACHE_INSERT: dup[i] = 1 iff tags[i] was already present
// (including an earlier index of this same batch); non-dups are inserted.
API void fd_tcache_insert_batch_dedup(void *h, const uint64_t *tags, int n,
                                      uint8_t *dup) {
  Tcache *tc = (Tcache *)h;
  for (int i = 0; i < n; i++) {
    dup[i] = tc_query(tc, tags[i]) ? 1 : 0;
    if (!dup[i]) tc_insert(tc, tags[i]);
  }
}

// Batched QUERY (no insert): hit[i] = 1 iff tags[i] is in the window.
// The packed-wire verify path pre-filters rows with this before device
// dispatch; tags are inserted only after verify passes (same rationale as
// the query-only tcache in fd_txn_parse_batch).
API void fd_tcache_query_batch(void *h, const uint64_t *tags, int n,
                               uint8_t *hit) {
  Tcache *tc = (Tcache *)h;
  for (int i = 0; i < n; i++) hit[i] = tc_query(tc, tags[i]) ? 1 : 0;
}

// -------------------------------------------------------------- batch parse

// Parse + dedup + bucket-fill a burst of serialized txns.
//
//   buf/offs:   concatenated payloads; payload i = buf[offs[i], offs[i+1])
//   n:          number of payloads
//   tcache:     optional dedup window (nullptr = no dedup); QUERY-only —
//               tags are inserted by the harvest path after verify passes
//               (inserting pre-verify would let a mangled copy poison the
//               window and block the valid retransmission)
//   maxlen:     bucket message width; longer messages get kErrTooLong
//   cap/lane0:  bucket lane capacity and first free lane
//   msgs/lens/sigs/pubs: the bucket arrays ((cap,maxlen) u8, (cap,) i32,
//               (cap,64) u8, (cap,32) u8) — one lane PER SIGNATURE,
//               message replicated across a txn's lanes
//   txn_lane0/txn_nsig/txn_tag/txn_err: per-txn outputs; nsig=0 for
//               dropped txns (err says why)
//
// Returns the number of txns CONSUMED: parsing stops (without consuming)
// at the first txn whose sig lanes don't fit the remaining capacity, so
// the caller flushes the bucket and re-enters with the tail.
// Strided core: msgs/sigs/pubs rows land at their pointer + lane*stride,
// so the bucket can be ONE packed (cap, maxlen+100) row-interleaved
// buffer (msgs | sigs | pubs | lens-le32 per row) — the DMA-blob shape
// the device dispatch uploads with a single transfer.  lens_bytes
// (nullable, stride msgs_stride) mirrors each lane's msg_len as 4 LE
// bytes into the packed row; the contiguous int32 lens array stays for
// host-side bookkeeping either way.
static int parse_batch_impl(
    const uint8_t *buf, const int64_t *offs, int n, void *tcache, int maxlen,
    int cap, int lane0, uint8_t *msgs, int64_t msgs_stride, int32_t *lens,
    uint8_t *sigs, int64_t sigs_stride, uint8_t *pubs, int64_t pubs_stride,
    uint8_t *lens_bytes, int32_t *txn_lane0, int32_t *txn_nsig,
    uint64_t *txn_tag, int32_t *txn_err, int32_t *lanes_used_out) {
  Tcache *tc = (Tcache *)tcache;
  int lane = lane0;
  int t = 0;
  for (; t < n; t++) {
    txn_lane0[t] = -1;
    txn_nsig[t] = 0;
    txn_tag[t] = 0;
    const uint8_t *p = buf + offs[t];
    int sz = (int)(offs[t + 1] - offs[t]);
    if (sz > kMtu) { txn_err[t] = kErrParse; continue; }
    Cursor c{p, sz};

    int sig_cnt = c.u8();
    if (c.fail || sig_cnt < 1 || sig_cnt > kSigMax) {
      txn_err[t] = kErrParse; continue;
    }
    if (!c.need(kSigSz * sig_cnt)) { txn_err[t] = kErrParse; continue; }
    int sig_off = c.i;
    c.i += kSigSz * sig_cnt;

    int msg_off = c.i;
    int b0 = c.u8();
    if (c.fail) { txn_err[t] = kErrParse; continue; }
    if (b0 & 0x80) {
      if ((b0 & 0x7F) != 0) { txn_err[t] = kErrParse; continue; }  // != v0
      int hdr_sig = c.u8();
      if (c.fail || hdr_sig != sig_cnt) { txn_err[t] = kErrParse; continue; }
    } else {
      if (b0 != sig_cnt) { txn_err[t] = kErrParse; continue; }
    }
    bool is_v0 = (b0 & 0x80) != 0;

    int ro_signed = c.u8();
    if (c.fail || ro_signed >= sig_cnt) { txn_err[t] = kErrParse; continue; }
    int ro_unsigned = c.u8();
    if (c.fail) { txn_err[t] = kErrParse; continue; }

    int acct_cnt = c.cu16();
    if (c.fail || acct_cnt < sig_cnt || acct_cnt > kAcctMax ||
        sig_cnt + ro_unsigned > acct_cnt) {
      txn_err[t] = kErrParse; continue;
    }
    if (!c.need(kPubSz * acct_cnt)) { txn_err[t] = kErrParse; continue; }
    int acct_off = c.i;
    c.i += kPubSz * acct_cnt;
    if (!c.need(kBlockhashSz)) { txn_err[t] = kErrParse; continue; }
    c.i += kBlockhashSz;

    int instr_cnt = c.cu16();
    if (c.fail || instr_cnt > kInstrMax) { txn_err[t] = kErrParse; continue; }
    if (!c.need(3 * instr_cnt)) { txn_err[t] = kErrParse; continue; }
    if (acct_cnt <= (instr_cnt ? 1 : 0)) { txn_err[t] = kErrParse; continue; }

    int max_acct = 0;
    bool bad = false;
    for (int k = 0; k < instr_cnt && !bad; k++) {
      int prog = c.u8();
      int nacc = c.cu16();
      if (c.fail || !c.need(nacc)) { bad = true; break; }
      for (int a = 0; a < nacc; a++)
        if (p[c.i + a] > max_acct) max_acct = p[c.i + a];
      c.i += nacc;
      int dsz = c.cu16();
      if (c.fail || !c.need(dsz)) { bad = true; break; }
      c.i += dsz;
      if (prog <= 0 || prog >= acct_cnt) { bad = true; break; }
    }
    if (bad || c.fail) { txn_err[t] = kErrParse; continue; }

    int adtl = 0;
    if (is_v0) {
      int lut_cnt = c.cu16();
      if (c.fail || lut_cnt > kAddrLutMax || !c.need(34 * lut_cnt)) {
        txn_err[t] = kErrParse; continue;
      }
      for (int k = 0; k < lut_cnt && !bad; k++) {
        if (!c.need(kPubSz)) { bad = true; break; }
        c.i += kPubSz;
        int wr = c.cu16();
        if (c.fail || !c.need(wr)) { bad = true; break; }
        c.i += wr;
        int ro = c.cu16();
        if (c.fail || !c.need(ro)) { bad = true; break; }
        c.i += ro;
        if (wr > kAcctMax - acct_cnt || ro > kAcctMax - acct_cnt ||
            wr + ro < 1) { bad = true; break; }
        adtl += wr + ro;
      }
      if (bad || c.fail) { txn_err[t] = kErrParse; continue; }
    }
    if (c.i != sz || acct_cnt + adtl > kAcctMax ||
        max_acct >= acct_cnt + adtl) {
      txn_err[t] = kErrParse; continue;
    }

    // ---- rules passed; route + dedup + fill
    int msg_len = sz - msg_off;
    if (msg_len > maxlen) { txn_err[t] = kErrTooLong; continue; }
    if (sig_cnt > cap) { txn_err[t] = kErrSigCap; continue; }
    uint64_t tag;
    memcpy(&tag, p + sig_off, 8);
    txn_tag[t] = tag;
    if (tc && tc_query(tc, tag)) { txn_err[t] = kErrDup; continue; }
    if (lane + sig_cnt > cap) break;  // bucket full: caller flushes

    txn_err[t] = kOk;
    txn_lane0[t] = lane;
    txn_nsig[t] = sig_cnt;
    for (int s = 0; s < sig_cnt; s++, lane++) {
      memcpy(msgs + (int64_t)lane * msgs_stride, p + msg_off, msg_len);
      if (msg_len < maxlen)
        memset(msgs + (int64_t)lane * msgs_stride + msg_len, 0,
               maxlen - msg_len);
      lens[lane] = msg_len;
      if (lens_bytes) {
        int32_t ml32 = msg_len;
        memcpy(lens_bytes + (int64_t)lane * msgs_stride, &ml32, 4);
      }
      memcpy(sigs + (int64_t)lane * sigs_stride, p + sig_off + s * kSigSz,
             kSigSz);
      memcpy(pubs + (int64_t)lane * pubs_stride, p + acct_off + s * kPubSz,
             kPubSz);
    }
  }
  *lanes_used_out = lane - lane0;
  return t;
}

API int fd_txn_parse_batch(
    const uint8_t *buf, const int64_t *offs, int n, void *tcache, int maxlen,
    int cap, int lane0, uint8_t *msgs, int32_t *lens, uint8_t *sigs,
    uint8_t *pubs, int32_t *txn_lane0, int32_t *txn_nsig, uint64_t *txn_tag,
    int32_t *txn_err, int32_t *lanes_used_out) {
  return parse_batch_impl(buf, offs, n, tcache, maxlen, cap, lane0, msgs,
                          maxlen, lens, sigs, kSigSz, pubs, kPubSz, nullptr,
                          txn_lane0, txn_nsig, txn_tag, txn_err,
                          lanes_used_out);
}

// Packed-bucket form: one (cap, row_stride) row-interleaved buffer with
// msgs at +0, sigs at +maxlen, pubs at +maxlen+64, lens-le32 at
// +maxlen+96 (row_stride >= maxlen + 100).
API int fd_txn_parse_batch_packed(
    const uint8_t *buf, const int64_t *offs, int n, void *tcache, int maxlen,
    int cap, int lane0, uint8_t *bucket, int64_t row_stride, int32_t *lens,
    int32_t *txn_lane0, int32_t *txn_nsig, uint64_t *txn_tag,
    int32_t *txn_err, int32_t *lanes_used_out) {
  return parse_batch_impl(buf, offs, n, tcache, maxlen, cap, lane0, bucket,
                          row_stride, lens, bucket + maxlen, row_stride,
                          bucket + maxlen + 64, row_stride,
                          bucket + maxlen + 96, txn_lane0, txn_nsig, txn_tag,
                          txn_err, lanes_used_out);
}
