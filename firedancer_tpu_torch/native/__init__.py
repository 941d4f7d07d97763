"""The port's host library, built with g++ at first use from four
sources: tango.cpp (the rings), txnparse.cpp (the burst txn parser and
the native tcache), hostpath.cpp (the packed rows' one-pass submit and
finish, which resolves the tcache's symbols at link time) and
packsched.cpp (the pack scheduler's hot loop).

The library goes to ``firedancer_tpu_torch/_build/host-<hash>/``, keyed by
a hash of every source and the flags, so a changed source rebuilds and an
unchanged one loads at once.  Every tile process loads it at boot, and
several may build it at the same moment: each compiles to a file of its
own pid and renames it into place.  A failed build raises; there is no
pure-Python ring, parser or tcache to fall back to, and the pack
scheduler runs its Python version only when asked (native_pack = 0).
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
SOURCES = tuple(_DIR / n for n in ("tango.cpp", "txnparse.cpp",
                                    "hostpath.cpp", "packsched.cpp"))
BUILD = _DIR.parent / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden")

_lock = threading.Lock()
_lib = None


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"host-{h.hexdigest()[:16]}" / "libfdtpu_host.so"


def build() -> str:
    """Compile the host library if it is not built yet; returns its path."""
    so = _so_path()
    if so.exists():
        return str(so)
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                           *map(str, SOURCES)],
                          capture_output=True, text=True)
    if proc.returncode:
        names = ", ".join(s.name for s in SOURCES)
        raise RuntimeError(f"g++ failed on {names}:\n{proc.stderr}")
    os.replace(tmp, so)
    return str(so)


def lib() -> ctypes.CDLL:
    """The loaded host library (built on first use)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _bind(ctypes.CDLL(build()))
    return _lib


def _bind(L: ctypes.CDLL) -> ctypes.CDLL:
    u64, u32, i32 = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int
    i64 = ctypes.c_int64
    p = ctypes.c_void_p
    sig = {
        "fd_mcache_align": (u64, []),
        "fd_mcache_footprint": (u64, [u64]),
        "fd_mcache_new": (i32, [p, u64, u64]),
        "fd_mcache_depth": (u64, [p]),
        "fd_mcache_seq0": (u64, [p]),
        "fd_mcache_seq_query": (u64, [p]),
        "fd_mcache_publish": (u64, [p, u64, u32, u32, u32, u32, u32]),
        "fd_mcache_query": (i32, [p, u64, p]),
        "fd_mcache_consume_burst": (i32, [p, u64, u64, p,
                                          ctypes.POINTER(u64)]),
        "fd_fseq_footprint": (u64, []),
        "fd_fseq_new": (None, [p, u64]),
        "fd_fseq_update": (None, [p, u64]),
        "fd_fseq_query": (u64, [p]),
        "fd_fseq_diag_add": (None, [p, u64, u64]),
        "fd_fseq_diag_query": (u64, [p, u64]),
        "fd_cnc_footprint": (u64, []),
        "fd_cnc_new": (None, [p]),
        "fd_cnc_signal": (None, [p, u64]),
        "fd_cnc_signal_query": (u64, [p]),
        "fd_cnc_heartbeat": (None, [p, u64]),
        "fd_cnc_heartbeat_query": (u64, [p]),
        "fd_dcache_chunk_sz": (u64, []),
        "fd_dcache_req_data_sz": (u64, [u64, u64, u64]),
        "fd_dcache_compact_next": (u64, [u64, u64, u64, u64]),
        "fd_ring_rx_burst": (i32, [p, p, u64, u64, u64, i32, i32,
                                   p, p, ctypes.c_int64, p, p, p, p]),
        "fd_ring_tx_burst": (u64, [p, p, u64, u64, u64, p, p, p, p,
                                   i32, u32, u32, p]),
        "fd_tcache_new": (p, [u64]),
        "fd_tcache_delete": (None, [p]),
        "fd_tcache_query": (i32, [p, u64]),
        "fd_tcache_insert": (None, [p, u64]),
        "fd_tcache_insert_batch": (None, [p, p, i32]),
        "fd_tcache_insert_batch_dedup": (None, [p, p, i32, p]),
        "fd_tcache_query_batch": (None, [p, p, i32, p]),
        "fd_hostpath_submit_rows": (i64, [p, i64, i32, i32, p, p, p]),
        "fd_hostpath_finish_rows": (i64, [p, i64, i32, i32, p, p, p, p, p,
                                          i64, p, p, p]),
        "fd_txn_parse_batch": (i32, [p, p, i32, p, i32, i32, i32,
                                     p, p, p, p, p, p, p, p, p]),
        "fd_txn_parse_batch_packed": (i32, [p, p, i32, p, i32, i32, i32,
                                            p, i64, p, p, p, p, p, p]),
        "fd_pack_new": (p, [i32, ctypes.c_longlong]),
        "fd_pack_delete": (None, [p]),
        "fd_pack_acct_key": (u64, [ctypes.c_char_p]),
        "fd_pack_insert": (ctypes.c_longlong,
                           [p, ctypes.c_char_p, ctypes.c_char_p]),
        "fd_pack_pending": (ctypes.c_longlong, [p]),
        "fd_pack_clear_pending": (None, [p]),
        "fd_pack_schedule": (ctypes.c_longlong,
                             [p, i32, i32, ctypes.POINTER(ctypes.c_longlong),
                              ctypes.POINTER(ctypes.c_longlong)]),
        "fd_pack_done": (None, [p, i32]),
        "fd_pack_end_block": (None, [p]),
    }
    for name, (res, args) in sig.items():
        fn = getattr(L, name)
        fn.restype = res
        fn.argtypes = args
    return L
