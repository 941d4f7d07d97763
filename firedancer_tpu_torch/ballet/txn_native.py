"""ctypes binding of the native burst txn parser (native/txnparse.cpp).

One C call parses a burst of serialized txns with fd_txn_parse's rules
(ref src/ballet/txn/fd_txn_parse.c:80-236), queries the first-signature
tag against a native tcache, and scatters msg/sig/pubkey bytes straight
into the verify bucket: the verify tile's host data plane without a
Python step a txn.

The port's own copy of firedancer_tpu/ballet/txn_native.py.  Rule parity
with ballet/txn.py parse is held by tests/test_torch_txn_native.py.
"""

import ctypes
from dataclasses import dataclass

import numpy as np

from .. import native

# error codes (native/txnparse.cpp)
OK = 0
ERR_PARSE = 1
ERR_TOO_LONG = 2
ERR_DUP = 3
ERR_SIG_CAP = 4


@dataclass
class BurstResult:
    consumed: int          # payloads processed (stop = bucket filled)
    lanes_used: int        # signature lanes written
    lane0: np.ndarray      # (consumed,) int32: first lane or -1
    nsig: np.ndarray       # (consumed,) int32: lanes used by txn (0=dropped)
    tag: np.ndarray        # (consumed,) uint64 dedup tags
    err: np.ndarray        # (consumed,) int32 error codes


def _buf_ptr(buf) -> ctypes.c_void_p:
    """Base pointer of a bytes / bytearray / memoryview / uint8 ndarray
    payload buffer, without a copy."""
    if isinstance(buf, (bytearray, memoryview)):
        buf = np.frombuffer(buf, dtype=np.uint8)
    if isinstance(buf, np.ndarray):
        return ctypes.c_void_p(buf.ctypes.data)
    return ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p)


def _vp(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def pack_payloads(payloads) -> tuple[bytes, np.ndarray]:
    """list[bytes] -> (flat buffer, int64 offsets (n+1)) for parse_packed."""
    offs = np.zeros(len(payloads) + 1, dtype=np.int64)
    np.cumsum([len(p) for p in payloads], out=offs[1:])
    return b"".join(payloads), offs


def _parse(entry, buf, offs, tcache_handle, maxlen, cap, lane0, *arrays):
    n = len(offs) - 1
    t_lane0 = np.empty(n, dtype=np.int32)
    t_nsig = np.empty(n, dtype=np.int32)
    t_tag = np.empty(n, dtype=np.uint64)
    t_err = np.empty(n, dtype=np.int32)
    lanes_used = np.zeros(1, dtype=np.int32)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    consumed = entry(
        _buf_ptr(buf), _vp(offs), n, tcache_handle, maxlen, cap, lane0,
        *arrays, _vp(t_lane0), _vp(t_nsig), _vp(t_tag), _vp(t_err),
        _vp(lanes_used))
    return BurstResult(consumed, int(lanes_used[0]), t_lane0[:consumed],
                       t_nsig[:consumed], t_tag[:consumed], t_err[:consumed])


def parse_burst(payloads, msgs: np.ndarray, lens: np.ndarray,
                sigs: np.ndarray, pubs: np.ndarray, lane0: int,
                tcache_handle=None) -> BurstResult:
    """parse_packed over a list[bytes]."""
    buf, offs = pack_payloads(payloads)
    return parse_packed(buf, offs, msgs, lens, sigs, pubs, lane0,
                        tcache_handle)


def parse_packed(buf, offs: np.ndarray, msgs: np.ndarray, lens: np.ndarray,
                 sigs: np.ndarray, pubs: np.ndarray, lane0: int,
                 tcache_handle=None) -> BurstResult:
    """Parse txns packed in a flat buffer into four bucket arrays
    ((cap, maxlen) u8, (cap,) i32, (cap, 64) u8, (cap, 32) u8, each
    C-contiguous) from lane `lane0` on.  Payload i = buf[offs[i]:
    offs[i+1]]; the offsets are ABSOLUTE into buf, so a caller resuming
    mid-burst passes offs[idx:] without repacking.  It stops early when
    the next txn's lanes do not fit: the caller flushes and re-enters.

    buf: bytes or a uint8 array (a ring's rx scratch, read in place).
    tcache_handle: NativeTCache.handle, QUERY only (the harvest inserts a
    tag once its txn verifies)."""
    for a, w in ((msgs, None), (lens, None), (sigs, 64), (pubs, 32)):
        if not a.flags.c_contiguous or (w is not None and a.shape[1] != w):
            raise ValueError("parse_packed needs C-contiguous bucket arrays "
                             "of widths (maxlen, -, 64, 32)")
    return _parse(native.lib().fd_txn_parse_batch, buf, offs, tcache_handle,
                  msgs.shape[1], msgs.shape[0], lane0, _vp(msgs), _vp(lens),
                  _vp(sigs), _vp(pubs))


def parse_packed_bucket(buf, offs: np.ndarray, bucket: np.ndarray,
                        maxlen: int, lens: np.ndarray, lane0: int,
                        tcache_handle=None) -> BurstResult:
    """parse_packed into a ROW-INTERLEAVED bucket, one (cap, stride) uint8
    array with msgs at +0, sigs at +maxlen, pubs at +maxlen+64 and the
    little-endian int32 msg_len at +maxlen+96 (stride >= maxlen+100): the
    device blob the dispatch uploads whole.  The C fill writes the rows in
    place, so `bucket` may be the NumPy view of a pinned torch blob.
    `lens` is a (cap,) int32 side array the fill writes too."""
    if not (bucket.dtype == np.uint8 and bucket.ndim == 2
            and bucket.flags.c_contiguous and bucket.shape[1] >= maxlen + 100):
        raise ValueError("parse_packed_bucket needs a C-contiguous (cap, "
                         ">= maxlen + 100) uint8 bucket")
    if not (lens.dtype == np.int32 and lens.flags.c_contiguous
            and len(lens) >= bucket.shape[0]):
        raise ValueError("parse_packed_bucket needs a (cap,) int32 lens")
    return _parse(native.lib().fd_txn_parse_batch_packed, buf, offs,
                  tcache_handle, maxlen, bucket.shape[0], lane0, _vp(bucket),
                  bucket.shape[1], _vp(lens))
