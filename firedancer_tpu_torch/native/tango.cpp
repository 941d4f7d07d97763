// tango: lock-free single-producer broadcast rings, flow control, and
// command-and-control, the host IPC fabric of the port's topologies.
//
// The port's own copy of firedancer_tpu/native/tango.cpp's ring, fseq, cnc
// and dcache functions (the reference's src/tango/mcache/fd_mcache.h,
// src/tango/fseq/fd_fseq.c, src/tango/cnc/fd_cnc.c): gapless 64-bit seqs,
// per-entry seqlock metas, overrun-by-regression detection,
// consumer-published fseq credits and a heartbeat cnc, as a
// position-independent C++ library over caller-provided memory (named
// shared memory mapped by firedancer_tpu_torch/tango/ring.py), so the same
// code runs in-process, across processes and under tests.  Its memory
// layouts are the JAX package's byte for byte, so either package's rings
// can read a workspace the other wrote.
//
// Concurrency model (per-entry seqlock, fd_tango_base.h:152-171):
//   producer: write all fields of line (seq & depth-1) with the seq word
//             stored LAST, release order.  The old occupant's seq differs
//             from the new one (it is seq - depth), so a concurrent reader
//             can never observe a half-written meta with a matching seq.
//   consumer: load seq word (acquire); if != want -> not-yet (lt) or
//             overrun (gt).  Copy meta, then re-load seq word; if changed,
//             the producer lapped us mid-copy -> overrun.
//
// Exported with C linkage for ctypes (firedancer_tpu_torch/native).

#include <atomic>
#include <cstdint>
#include <cstring>

typedef uint64_t ulong_t;
typedef uint32_t uint_t;

#define FD_EXPORT extern "C" __attribute__((visibility("default")))

// ---------------------------------------------------------------------------
// frag meta: 32 bytes, cacheline-pair friendly (fd_tango_base.h:152-171)

struct alignas(32) frag_meta {
  std::atomic<ulong_t> seq;  // version word: entry valid iff seq == want
  ulong_t sig;               // app signature (dedup key / filter w/o payload)
  uint_t chunk;              // dcache chunk index of payload
  uint16_t sz;               // payload size in bytes
  uint16_t ctl;              // SOM/EOM/ERR + origin id (fd_tango_base.h:76-99)
  uint_t tsorig;             // compressed origin timestamp
  uint_t tspub;              // compressed publish timestamp
};
static_assert(sizeof(frag_meta) == 32, "frag_meta must be 32 bytes");

// mcache memory layout: [ header (128B) | frag_meta[depth] ]
struct alignas(64) mcache_hdr {
  ulong_t magic;
  ulong_t depth;      // power of two
  ulong_t seq0;       // initial sequence number
  std::atomic<ulong_t> seq;  // producer cursor: next seq to publish
  uint8_t pad[96];
};
static_assert(sizeof(mcache_hdr) == 128, "mcache_hdr must be 128 bytes");

static const ulong_t MCACHE_MAGIC = 0xfd7a6f0c0c0ffee1UL;

static inline frag_meta* mcache_ring(void* mem) {
  return reinterpret_cast<frag_meta*>(static_cast<uint8_t*>(mem) + sizeof(mcache_hdr));
}

FD_EXPORT ulong_t fd_mcache_align(void) { return 64; }

FD_EXPORT ulong_t fd_mcache_footprint(ulong_t depth) {
  // power of two, >= 2 (the seq-1 invalidation word must not alias a
  // want-seq on the same line, which needs depth >= 2)
  if (depth < 2 || (depth & (depth - 1))) return 0;
  return sizeof(mcache_hdr) + depth * sizeof(frag_meta);
}

FD_EXPORT int fd_mcache_new(void* mem, ulong_t depth, ulong_t seq0) {
  if (!fd_mcache_footprint(depth)) return -1;
  mcache_hdr* h = static_cast<mcache_hdr*>(mem);
  std::memset(mem, 0, fd_mcache_footprint(depth));
  h->depth = depth;
  h->seq0 = seq0;
  h->seq.store(seq0, std::memory_order_relaxed);
  frag_meta* ring = mcache_ring(mem);
  // Seed entries so no line ever matches a pre-publish want: entry i holds
  // seq0 + i - depth (i.e. "one lap ago"), mirroring fd_mcache_new's init.
  for (ulong_t i = 0; i < depth; i++)
    ring[i].seq.store(seq0 + i - depth, std::memory_order_relaxed);
  std::atomic_thread_fence(std::memory_order_release);
  h->magic = MCACHE_MAGIC;
  return 0;
}

FD_EXPORT ulong_t fd_mcache_depth(void* mem) {
  mcache_hdr* h = static_cast<mcache_hdr*>(mem);
  return h->magic == MCACHE_MAGIC ? h->depth : 0;
}

FD_EXPORT ulong_t fd_mcache_seq0(void* mem) {
  return static_cast<mcache_hdr*>(mem)->seq0;
}

// producer cursor (next seq to be published), for lazy consumer resync
FD_EXPORT ulong_t fd_mcache_seq_query(void* mem) {
  return static_cast<mcache_hdr*>(mem)->seq.load(std::memory_order_acquire);
}

// Publish one frag at the producer cursor; returns the seq it got.
// Single producer only (the reference's contract too).
FD_EXPORT ulong_t fd_mcache_publish(void* mem, ulong_t sig, uint_t chunk,
                                    uint_t sz, uint_t ctl, uint_t tsorig,
                                    uint_t tspub) {
  mcache_hdr* h = static_cast<mcache_hdr*>(mem);
  ulong_t seq = h->seq.load(std::memory_order_relaxed);
  frag_meta* m = mcache_ring(mem) + (seq & (h->depth - 1));
  // Invalidate the line first so a reader that matched the OLD seq and is
  // mid-copy re-reads a changed version word (seqlock write begin).  The
  // fence is the store-store barrier keeping the data writes below from
  // hoisting above the invalidation (the reference's FD_COMPILER_MFENCE at
  // this spot; compiler barrier on x86-TSO, dmb st on weaker hw).
  m->seq.store(seq - 1, std::memory_order_relaxed);
  std::atomic_thread_fence(std::memory_order_release);
  m->sig = sig;
  m->chunk = chunk;
  m->sz = static_cast<uint16_t>(sz);
  m->ctl = static_cast<uint16_t>(ctl);
  m->tsorig = tsorig;
  m->tspub = tspub;
  m->seq.store(seq, std::memory_order_release);  // seqlock write end
  h->seq.store(seq + 1, std::memory_order_release);
  return seq;
}

// Consumer poll for `want`.  out must hold 32 bytes.
// Returns 0 = got it, -1 = not yet published, 1 = overrun (caller must
// resync via fd_mcache_seq_query and count the loss).
FD_EXPORT int fd_mcache_query(void* mem, ulong_t want, void* out) {
  mcache_hdr* h = static_cast<mcache_hdr*>(mem);
  frag_meta* m = mcache_ring(mem) + (want & (h->depth - 1));
  ulong_t s0 = m->seq.load(std::memory_order_acquire);
  if (s0 != want) {
    // signed distance handles wraparound the way the reference does
    return (static_cast<int64_t>(s0 - want) < 0) ? -1 : 1;
  }
  std::memcpy(out, m, sizeof(frag_meta));
  std::atomic_thread_fence(std::memory_order_acquire);
  ulong_t s1 = m->seq.load(std::memory_order_relaxed);
  return (s1 == want) ? 0 : 1;  // changed mid-copy -> lapped -> overrun
}

// Batch consume: copy metas for [want, want+max) into out (32B stride)
// until not-yet/overrun.  Writes number consumed to *n_out; returns the
// status of the FIRST non-consumed slot (0 if max consumed, -1 not yet,
// 1 overrun).  This is the Python host's amortization lever: one ctypes
// call drains a burst.
FD_EXPORT int fd_mcache_consume_burst(void* mem, ulong_t want, ulong_t max,
                                      void* out, ulong_t* n_out) {
  uint8_t* dst = static_cast<uint8_t*>(out);
  ulong_t n = 0;
  int rc = 0;
  while (n < max) {
    rc = fd_mcache_query(mem, want + n, dst + 32 * n);
    if (rc) break;
    n++;
  }
  *n_out = n;
  return n == max ? 0 : rc;
}

// ---------------------------------------------------------------------------
// fseq: consumer -> producer flow control cacheline (src/tango/fseq/fd_fseq.c)
// layout: [ seq | 7 diag ulongs ] in one 64-byte line.

struct alignas(64) fseq_line {
  std::atomic<ulong_t> seq;
  std::atomic<ulong_t> diag[7];
};
static_assert(sizeof(fseq_line) == 64, "fseq must be one cacheline");

// diag indices (mirrors FD_FSEQ_DIAG_* in src/disco/mux/fd_mux.c usage)
//   0 pub_cnt, 1 pub_sz, 2 filt_cnt, 3 filt_sz, 4 ovrnp_cnt, 5 ovrnr_cnt,
//   6 slow_cnt

FD_EXPORT ulong_t fd_fseq_footprint(void) { return sizeof(fseq_line); }

FD_EXPORT void fd_fseq_new(void* mem, ulong_t seq0) {
  fseq_line* f = static_cast<fseq_line*>(mem);
  f->seq.store(seq0, std::memory_order_relaxed);
  for (int i = 0; i < 7; i++) f->diag[i].store(0, std::memory_order_relaxed);
  std::atomic_thread_fence(std::memory_order_release);
}

FD_EXPORT void fd_fseq_update(void* mem, ulong_t seq) {
  static_cast<fseq_line*>(mem)->seq.store(seq, std::memory_order_release);
}

FD_EXPORT ulong_t fd_fseq_query(void* mem) {
  return static_cast<fseq_line*>(mem)->seq.load(std::memory_order_acquire);
}

FD_EXPORT void fd_fseq_diag_add(void* mem, ulong_t idx, ulong_t delta) {
  static_cast<fseq_line*>(mem)->diag[idx & 7].fetch_add(
      delta, std::memory_order_relaxed);
}

FD_EXPORT ulong_t fd_fseq_diag_query(void* mem, ulong_t idx) {
  return static_cast<fseq_line*>(mem)->diag[idx & 7].load(
      std::memory_order_relaxed);
}

// ---------------------------------------------------------------------------
// cnc: command-and-control + heartbeat (src/tango/cnc/fd_cnc.c).
// layout: [ signal | heartbeat | 6 app ulongs ] in one line.
// signals mirror fd_cnc FD_CNC_SIGNAL_*: 0 RUN, 1 BOOT, 2 FAIL, 3 HALT
// (app-defined above 3).

struct alignas(64) cnc_line {
  std::atomic<ulong_t> signal;
  std::atomic<ulong_t> heartbeat;
  std::atomic<ulong_t> app[6];
};
static_assert(sizeof(cnc_line) == 64, "cnc must be one cacheline");

FD_EXPORT ulong_t fd_cnc_footprint(void) { return sizeof(cnc_line); }

FD_EXPORT void fd_cnc_new(void* mem) {
  cnc_line* c = static_cast<cnc_line*>(mem);
  c->signal.store(1 /* BOOT */, std::memory_order_relaxed);
  c->heartbeat.store(0, std::memory_order_relaxed);
  for (int i = 0; i < 6; i++) c->app[i].store(0, std::memory_order_relaxed);
  std::atomic_thread_fence(std::memory_order_release);
}

FD_EXPORT void fd_cnc_signal(void* mem, ulong_t sig) {
  static_cast<cnc_line*>(mem)->signal.store(sig, std::memory_order_release);
}

FD_EXPORT ulong_t fd_cnc_signal_query(void* mem) {
  return static_cast<cnc_line*>(mem)->signal.load(std::memory_order_acquire);
}

FD_EXPORT void fd_cnc_heartbeat(void* mem, ulong_t now) {
  static_cast<cnc_line*>(mem)->heartbeat.store(now, std::memory_order_release);
}

FD_EXPORT ulong_t fd_cnc_heartbeat_query(void* mem) {
  return static_cast<cnc_line*>(mem)->heartbeat.load(std::memory_order_acquire);
}

// ---------------------------------------------------------------------------
// dcache helpers (src/tango/dcache/fd_dcache.c): payload region addressed by
// chunk index; compact ring allocation a la fd_dcache_compact_next.

static const ulong_t CHUNK_LG_SZ = 6;  // 64B chunks (FD_CHUNK_LG_SZ)

FD_EXPORT ulong_t fd_dcache_chunk_sz(void) { return 1UL << CHUNK_LG_SZ; }

// footprint for a compact ring holding bursts of mtu-sized frags at `depth`
// outstanding (mirrors fd_dcache_req_data_sz, fd_dcache.h)
FD_EXPORT ulong_t fd_dcache_req_data_sz(ulong_t mtu, ulong_t depth,
                                        ulong_t burst) {
  ulong_t chunk = 1UL << CHUNK_LG_SZ;
  ulong_t mtu_chunks = (mtu + chunk - 1) >> CHUNK_LG_SZ;
  return (depth + burst + 1) * mtu_chunks * chunk;
}

// next chunk index for a compact ring write of sz bytes
FD_EXPORT ulong_t fd_dcache_compact_next(ulong_t chunk, ulong_t sz,
                                         ulong_t chunk0, ulong_t wmark) {
  ulong_t chunks = ((sz + (1UL << CHUNK_LG_SZ) - 1) >> CHUNK_LG_SZ);
  ulong_t next = chunk + chunks;
  return next > wmark ? chunk0 : next;
}

// ---------------------------------------------------------------------------
// Burst data plane: one C call per burst for the rx
// (consume + seqlock-validated payload copy + round-robin filter) and tx
// (dcache write + publish) sides.  This is what lets a Python tile process
// move hundreds of thousands of frags/s: the per-frag work never crosses
// the ctypes boundary.  Contracts identical to the per-frag calls above.

// Consume up to `max` frags starting at `want`.  Frags whose
// seq % rr_cnt != rr_idx are filtered (counted, not copied) — the verify
// tile's round-robin sharding (ref fd_verify.c:36-47) applied at the ring.
// Payloads of kept frags are copied from the dcache data area with seqlock
// re-validation; metas land in metas_out (32B stride, kept frags only),
// payload bytes concatenate into buf with offs_out[i] the start of kept
// frag i (offs_out[n_kept] = total).  Stops at not-yet, overrun, buf
// full, or max.
// Returns the status of the first unconsumed slot (0 burst full/buf full,
// -1 caught up, 1 overrun at that slot — caller resyncs).  *consumed_out =
// frags consumed (kept + filtered), *kept_out = kept, *filt_out = filtered.
FD_EXPORT int fd_ring_rx_burst(void* mc, const uint8_t* dc_data,
                               ulong_t chunk_sz, ulong_t want, ulong_t max,
                               int rr_cnt, int rr_idx, void* metas_out,
                               uint8_t* buf, int64_t buf_cap,
                               int64_t* offs_out, ulong_t* consumed_out,
                               ulong_t* kept_out, ulong_t* filt_out) {
  mcache_hdr* h = static_cast<mcache_hdr*>(mc);
  frag_meta* ring = mcache_ring(mc);
  ulong_t consumed = 0, kept = 0, filt = 0;
  int64_t used = 0;
  int rc = 0;
  offs_out[0] = 0;
  while (consumed < max) {
    ulong_t seq = want + consumed;
    frag_meta* m = ring + (seq & (h->depth - 1));
    ulong_t s0 = m->seq.load(std::memory_order_acquire);
    if (s0 != seq) {
      rc = (static_cast<int64_t>(s0 - seq) < 0) ? -1 : 1;
      break;
    }
    if (rr_cnt > 1 && (int)(seq % (ulong_t)rr_cnt) != rr_idx) {
      consumed++;
      filt++;
      continue;
    }
    frag_meta tmp;
    std::memcpy(&tmp, m, sizeof tmp);
    int64_t sz = tmp.sz;
    if (used + sz > buf_cap) {
      if (used == 0 && sz > buf_cap) {
        // frag wider than the whole rx buffer (buggy/hostile in-process
        // producer): consuming zero frags forever would wedge this input
        // permanently: drop it, count it as filtered.  But
        // first re-validate the seqlock: a producer lapping us mid-read
        // can tear sz, and that case must surface as an overrun/resync,
        // not a silent filtered skip
        std::atomic_thread_fence(std::memory_order_acquire);
        if (m->seq.load(std::memory_order_relaxed) != seq) {
          rc = 1;
          break;
        }
        consumed++;
        filt++;
        continue;
      }
      rc = 0;  // buf full: stop cleanly
      break;
    }
    if (sz) std::memcpy(buf + used, dc_data + (ulong_t)tmp.chunk * chunk_sz,
                        (size_t)sz);
    std::atomic_thread_fence(std::memory_order_acquire);
    if (m->seq.load(std::memory_order_relaxed) != seq) {
      rc = 1;  // producer lapped us mid-copy
      break;
    }
    std::memcpy(static_cast<uint8_t*>(metas_out) + 32 * kept, &tmp,
                sizeof tmp);
    used += sz;
    kept++;
    offs_out[kept] = used;
    consumed++;
  }
  *consumed_out = consumed;
  *kept_out = kept;
  *filt_out = filt;
  return consumed == max ? 0 : rc;
}

// Publish n frags from a flat buffer: payload i = buf[starts[i],
// starts[i]+lens[i]), app sig sigs[i], ctl SOM|EOM (origin 0).
// Writes payloads into the dcache compact ring starting at *chunk_io
// (updated on return).  The CALLER must hold >= n credits — this function
// does no flow control.  Returns the last seq published.
FD_EXPORT ulong_t fd_ring_tx_burst(void* mc, uint8_t* dc_data,
                                   ulong_t chunk_sz, ulong_t chunk0,
                                   ulong_t wmark, const uint8_t* buf,
                                   const int64_t* starts,
                                   const int32_t* lens,
                                   const ulong_t* sigs, int n, uint_t tsorig,
                                   uint_t tspub, ulong_t* chunk_io) {
  ulong_t chunk = *chunk_io;
  ulong_t seq = 0;
  for (int i = 0; i < n; i++) {
    int64_t sz = lens[i];
    if (sz) std::memcpy(dc_data + chunk * chunk_sz, buf + starts[i],
                        (size_t)sz);
    // ctl = origin<<3 | SOM<<2 | EOM<<1 | ERR (fd_tango_base.h:76-99)
    seq = fd_mcache_publish(mc, sigs[i], (uint_t)chunk, (uint_t)sz,
                            0x6 /* SOM|EOM */, tsorig, tspub);
    // compact-ring advance (fd_dcache_compact_next)
    ulong_t chunks = ((ulong_t)sz + chunk_sz - 1) / chunk_sz;
    ulong_t next = chunk + chunks;
    chunk = next > wmark ? chunk0 : next;
  }
  *chunk_io = chunk;
  return seq;
}
