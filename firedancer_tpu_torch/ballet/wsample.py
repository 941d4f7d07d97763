"""Weighted random sampling — leader schedules and turbine trees.

Reference role: src/ballet/wsample/ (fd_wsample.c) — stake-weighted
sampling driven by a ChaCha20Rng, used by the leader schedule
(src/flamenco/leaders/) and turbine shred destinations
(src/disco/shred/fd_shred_dest.c).  Supports sampling with and without
replacement ("remove" mode) and matches the draw discipline of Rust's
WeightedIndex bit-for-bit: one uniform draw in [0, total_weight) via the
Lemire multiply-high roll (ChaCha20Rng.roll_u64, MODE_MOD for leader
schedules / MODE_SHIFT for turbine — fd_chacha20rng.h:21-24), then a
search over cumulative weights.  Wire-exactness is fixture-tested against
the reference algorithm (tests/golden/wsample_ref.json).

The index is a Fenwick (binary indexed) tree so without-replacement
removal stays O(log n) — the same complexity story as the reference's
radix-9 left-sum tree (fd_wsample.c:14-96; ordering semantics identical,
only the search structure differs).

The port's own copy of firedancer_tpu/ballet/wsample.py.
"""

from ..ballet.chacha20 import ChaCha20Rng


class WSample:
    def __init__(self, weights: list[int], mode: int = ChaCha20Rng.MODE_MOD):
        self.mode = mode
        if any(w < 0 for w in weights):
            raise ValueError("weights must be non-negative")
        self.n = len(weights)
        self._fen = [0] * (self.n + 1)
        self._w = [0] * self.n
        for i, w in enumerate(weights):
            if w:
                self._add(i, w)
        if self.total == 0:
            raise ValueError("total weight must be positive")

    # Fenwick primitives -------------------------------------------------
    def _add(self, i: int, delta: int):
        self._w[i] += delta
        i += 1
        while i <= self.n:
            self._fen[i] += delta
            i += i & (-i)

    @property
    def total(self) -> int:
        return self._fen_prefix(self.n)

    def _fen_prefix(self, i: int) -> int:
        s = 0
        while i > 0:
            s += self._fen[i]
            i -= i & (-i)
        return s

    def _find(self, x: int) -> int:
        """Smallest index i with prefix_sum(i+1) > x (x < total)."""
        pos = 0
        bit = 1 << (self.n.bit_length())
        while bit:
            nxt = pos + bit
            if nxt <= self.n and self._fen[nxt] <= x:
                x -= self._fen[nxt]
                pos = nxt
            bit >>= 1
        return pos  # 0-based index

    # sampling -----------------------------------------------------------
    def sample(self, rng: ChaCha20Rng) -> int:
        """One draw with replacement."""
        return self._find(rng.roll_u64(self.total, self.mode))

    def sample_and_remove(self, rng: ChaCha20Rng) -> int:
        """One draw without replacement (turbine tree construction)."""
        i = self._find(rng.roll_u64(self.total, self.mode))
        self._add(i, -self._w[i])
        return i

    def sample_many(self, rng: ChaCha20Rng, cnt: int) -> list[int]:
        return [self.sample(rng) for _ in range(cnt)]
