"""Recently-seen-tag dedup cache (the reference's fd_tcache,
src/tango/tcache/fd_tcache.c): a fixed-depth ring of 64-bit tags plus a
membership map.  Inserting into a full cache evicts the oldest tag; zero
is the null tag and is never cached.

The port's own copy of firedancer_tpu/tango/tcache.py's TCache and
NativeTCache.  NativeTCache (native/txnparse.cpp) is the one the verify
pipeline and the dedup tile hold: the burst parser and the host path's
finish query and insert it from C.  TCache is its plain version, with the
same methods and the same answers.
"""

import ctypes

import numpy as np


def _u64(tags) -> np.ndarray:
    return np.ascontiguousarray(tags, dtype=np.uint64)


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


class TCache:
    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError("tcache depth must be >= 1")
        self.depth = depth
        self._ring: list[int] = [0] * depth
        self._next = 0
        self._set: set[int] = set()

    def query(self, tag: int) -> bool:
        """True if tag was seen within the last `depth` distinct inserts."""
        return tag != 0 and tag in self._set

    def query_batch(self, tags):
        """Bool mask of which tags are in the window (no insert)."""
        return np.array([self.query(int(t)) for t in tags], dtype=bool)

    def insert(self, tag: int) -> bool:
        """Insert tag; returns True if it was a DUPLICATE (already present).
        The query+insert pair is the reference's FD_TCACHE_INSERT macro."""
        if tag == 0:
            return False
        if tag in self._set:
            return True
        old = self._ring[self._next]
        if old != 0:
            self._set.discard(old)
        self._ring[self._next] = tag
        self._next = (self._next + 1) % self.depth
        self._set.add(tag)
        return False

    def insert_batch(self, tags) -> None:
        for t in tags:
            self.insert(int(t))

    def insert_batch_dedup(self, tags):
        """insert() over tags in order: bool mask, True where the tag was
        already present, an earlier index of this batch included."""
        return np.array([self.insert(int(t)) for t in tags], dtype=bool)

    def reset(self):
        self._ring = [0] * self.depth
        self._next = 0
        self._set.clear()


class NativeTCache:
    """The same contract over the C++ tcache (native/txnparse.cpp), whose
    handle the burst parser and the host path take.  Building the host
    library is part of construction: a failed build raises."""

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError("tcache depth must be >= 1")
        from .. import native
        self._L = native.lib()
        self.depth = depth
        self._h = self._L.fd_tcache_new(depth)

    @property
    def handle(self):
        """Opaque pointer for native callers (fd_txn_parse_batch_packed,
        fd_hostpath_*)."""
        return self._h

    def query(self, tag: int) -> bool:
        return bool(self._L.fd_tcache_query(self._h, tag))

    def insert(self, tag: int) -> bool:
        if self._L.fd_tcache_query(self._h, tag):
            return True
        self._L.fd_tcache_insert(self._h, tag)
        return False

    def insert_batch(self, tags) -> None:
        """Insert a uint64 array in order, in one call."""
        tags = _u64(tags)
        self._L.fd_tcache_insert_batch(self._h, _ptr(tags), len(tags))

    def query_batch(self, tags):
        """Bool mask, True where the tag is in the window (no insert), in
        one call."""
        tags = _u64(tags)
        hit = np.empty(len(tags), dtype=np.uint8)
        self._L.fd_tcache_query_batch(self._h, _ptr(tags), len(tags),
                                      _ptr(hit))
        return hit.view(bool)

    def insert_batch_dedup(self, tags):
        """FD_TCACHE_INSERT over tags in order, in one call: bool mask,
        True where the tag was already present, an earlier index of this
        batch included; the rest are inserted."""
        tags = _u64(tags)
        dup = np.empty(len(tags), dtype=np.uint8)
        self._L.fd_tcache_insert_batch_dedup(self._h, _ptr(tags), len(tags),
                                             _ptr(dup))
        return dup.view(bool)

    def reset(self):
        self._L.fd_tcache_delete(self._h)
        self._h = self._L.fd_tcache_new(self.depth)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._L.fd_tcache_delete(h)
            self._h = None
