"""Recently-seen-tag dedup cache (the reference's fd_tcache,
src/tango/tcache/fd_tcache.c): a fixed-depth ring of 64-bit tags plus a
membership map.  Inserting into a full cache evicts the oldest tag; zero
is the null tag and is never cached.

The port's own copy of firedancer_tpu/tango/tcache.py's TCache.  The
native tcache the JAX package queries from C comes with the port's native
host path.
"""

import numpy as np


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

    def reset(self):
        self._ring = [0] * self.depth
        self._next = 0
        self._set.clear()
