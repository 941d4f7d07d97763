// One-pass host path of the packed verify loop.
//
// Two entry points, one C call a frag each, over the tcache of
// txnparse.cpp (same shared library, resolved at link), so the dedup
// window is the one every other path shares.
//
// Submit: a strided 8 B tag gather straight off the row view and one
// fd_tcache_query_batch (QUERY only: tags are inserted at harvest iff
// the txn verifies, the FD_TCACHE_INSERT-at-publish contract).
//
// Harvest: verdict masking (ok & !dup & live), a conditional
// fd_tcache_insert_batch_dedup over the passing tags, and the wire build
// (0x01 | sig[64] | msg[len], by one memcpy a row) into a caller-provided
// arena with an offsets table.  If the passing wires do not fit the
// arena, the call returns -(needed bytes) WITHOUT touching the tcache, so
// the caller can grow the arena and retry with the same result.
//
// The port's own copy of firedancer_tpu/native/hostpath.cpp, the same
// code.  C ABI (ctypes): flat arrays only.  Row layout (the device blob's
// packed rows): msg[ml] | sig[64] | pub[32] | len_le32[4]; dedup tag =
// low 64 bits of the signature = row[ml:ml+8] LE; tag 0 marks a dead
// lane.

#include <cstdint>
#include <cstring>

#define API extern "C" __attribute__((visibility("default")))

// txnparse.cpp exports (same shared library)
extern "C" void fd_tcache_query_batch(void *h, const uint64_t *tags, int n,
                                      uint8_t *hit);
extern "C" void fd_tcache_insert_batch_dedup(void *h, const uint64_t *tags,
                                             int n, uint8_t *dup);

namespace {

constexpr int kSigSz = 64;
constexpr int kLenOff = kSigSz + 32;  // len_le32 sits after sig|pub
constexpr int kMaxBatch = 1 << 16;    // passing-set scratch bound per frag

inline uint64_t row_tag(const uint8_t *row, int ml) {
  uint64_t t;
  std::memcpy(&t, row + ml, 8);  // low 64 bits of sig, LE host
  return t;
}

inline int row_len(const uint8_t *row, int ml) {
  int32_t l;
  std::memcpy(&l, row + ml + kLenOff, 4);
  // defensive clamp: a torn/garbage row must not drive memcpy off the lane
  if (l < 0) return 0;
  if (l > ml) return ml;
  return (int)l;
}

}  // namespace

// Submit side: gather the dedup tag of every lane (strided — `rows` is a
// dcache view whose row pitch is the bucket stride, not ml+100) and run
// one batched tcache QUERY.  tag_out[i] = lane tag (0 = dead lane),
// dup_out[i] = 1 iff the tag is already in the dedup window.  Returns the
// number of dup lanes.  tcache may be null (dedup off): dup_out zeroed.
API int64_t fd_hostpath_submit_rows(const uint8_t *rows, int64_t row_stride,
                                    int n, int ml, void *tcache,
                                    uint64_t *tag_out, uint8_t *dup_out) {
  if (n <= 0) return 0;
  for (int i = 0; i < n; i++)
    tag_out[i] = row_tag(rows + (int64_t)i * row_stride, ml);
  if (!tcache) {
    std::memset(dup_out, 0, (size_t)n);
    return 0;
  }
  fd_tcache_query_batch(tcache, tag_out, n, dup_out);
  int64_t ndup = 0;
  for (int i = 0; i < n; i++) ndup += dup_out[i];
  return ndup;
}

// Harvest side: one pass over the verdict.  Inputs are the submit-time
// tag/dup arrays plus the device verdict ok[i] (1 = signature valid).
//
//   live    = tag != 0
//   passing = ok & !dup & live           (candidates for publish)
//   vfail   = live & !dup & !ok          (counted, never published)
//
// Passing tags are inserted via fd_tcache_insert_batch_dedup (dup2[i]=1
// iff already present, including earlier indices of the same batch —
// those are dropped as harvest-time dups).  Survivor wires are written
// back-to-back into `arena`:  arena[offs[j] .. offs[j+1]] =
// 0x01 | sig[64] | msg[len_j], with offs having k+1 entries and
// keep_tag[j] the survivor's tag.  counts = {verify_fail, dup2_drops,
// passing}.  Returns k (survivor count), or -(needed bytes) if arena_cap
// is too small — in that case NOTHING was inserted into the tcache and
// the call can be retried verbatim with a larger arena.
API int64_t fd_hostpath_finish_rows(const uint8_t *rows, int64_t row_stride,
                                    int n, int ml, const uint8_t *ok,
                                    const uint64_t *tag, const uint8_t *dup,
                                    void *tcache, uint8_t *arena,
                                    int64_t arena_cap, int64_t *offs,
                                    uint64_t *keep_tag, int64_t *counts) {
  counts[0] = counts[1] = counts[2] = 0;
  if (n <= 0 || n > kMaxBatch) {
    offs[0] = 0;
    return n <= 0 ? 0 : -1;
  }

  static thread_local int pass_idx[kMaxBatch];
  static thread_local uint64_t pass_tag[kMaxBatch];
  static thread_local uint8_t dup2[kMaxBatch];

  int np = 0;
  int64_t vfail = 0, need = 0;
  for (int i = 0; i < n; i++) {
    if (!tag[i] || dup[i]) continue;  // dead lane or submit-time dup
    const uint8_t *row = rows + (int64_t)i * row_stride;
    if (!ok[i]) {
      vfail++;
      continue;
    }
    pass_idx[np] = i;
    pass_tag[np] = tag[i];
    np++;
    need += 1 + kSigSz + row_len(row, ml);
  }
  counts[0] = vfail;
  counts[2] = np;
  if (need > arena_cap) return -need;  // tcache untouched: retry-safe

  if (tcache && np)
    fd_tcache_insert_batch_dedup(tcache, pass_tag, np, dup2);
  else
    std::memset(dup2, 0, (size_t)np);

  int64_t k = 0, o = 0;
  offs[0] = 0;
  for (int j = 0; j < np; j++) {
    if (dup2[j]) continue;  // harvest-time dup (raced within the window)
    const uint8_t *row = rows + (int64_t)pass_idx[j] * row_stride;
    int len = row_len(row, ml);
    arena[o] = 0x01;
    std::memcpy(arena + o + 1, row + ml, kSigSz);
    std::memcpy(arena + o + 1 + kSigSz, row, (size_t)len);
    o += 1 + kSigSz + len;
    keep_tag[k] = pass_tag[j];
    offs[++k] = o;
  }
  counts[1] = np - k;
  return k;
}
