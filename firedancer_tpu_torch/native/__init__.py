"""The port's host library (tango.cpp), built with g++ at first use.

The library goes to ``firedancer_tpu_torch/_build/host-<hash>/``, keyed by
a hash of the source and the flags, so a changed source rebuilds and an
unchanged one loads at once.  Every tile process loads it at boot, and
several may build it at the same moment: each compiles to a file of its
own pid and renames it into place.  A failed build raises; there is no
pure-Python ring to fall back to.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "tango.cpp"
BUILD = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden")

_lock = threading.Lock()
_lib = None


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD / f"host-{h.hexdigest()[:16]}" / "libfdtpu_tango.so"


def build() -> str:
    """Compile the host library if it is not built yet; returns its path."""
    so = _so_path()
    if so.exists():
        return str(so)
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"g++ failed on {SRC.name}:\n{proc.stderr}")
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
    }
    for name, (res, args) in sig.items():
        fn = getattr(L, name)
        fn.restype = res
        fn.argtypes = args
    return L
