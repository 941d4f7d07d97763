"""Fixed-bucket histograms for metrics (src/util/hist/fd_histf.h:
exponential-bucket approximate histograms feeding the metrics region).
The port's own copy of firedancer_tpu/utils/hist.py."""

import numpy as np


class Histf:
    """Exponentially-bucketed histogram over [min_val, max_val],
    numpy-backed, single-writer (one per tile, like the reference's
    per-tile hist).

    counts[i] holds samples v with edges[i-1] < v <= edges[i]
    (searchsorted, left); counts[-1] is the explicit OVERFLOW bucket:
    every sample above max_val lands there and shows in overflow_cnt(),
    never merged into the top finite bucket."""

    def __init__(self, min_val: float, max_val: float, nbuckets: int = 32):
        if not 0 < min_val < max_val:
            raise ValueError(f"need 0 < min_val < max_val, got "
                             f"{min_val}, {max_val}")
        self.edges = np.geomspace(min_val, max_val, nbuckets - 1)
        self.counts = np.zeros(nbuckets, dtype=np.uint64)
        self.sum = 0.0

    def sample(self, v: float):
        self.counts[np.searchsorted(self.edges, v)] += 1
        self.sum += v

    def count(self) -> int:
        return int(self.counts.sum())

    def overflow_cnt(self) -> int:
        """Samples above max_val (fd_histf_cnt's overflow slot): nonzero
        means the range is too narrow for the distribution measured."""
        return int(self.counts[-1])

    def percentile(self, q: float) -> float:
        total = int(self.counts.sum())
        if total == 0:
            return 0.0
        cum = np.cumsum(self.counts)
        # first bucket whose cumulative count reaches q*total; side="left"
        # matches the reference's acc >= target scan
        i = int(np.searchsorted(cum, np.uint64(max(1, int(np.ceil(
            q * total))))))
        return float(self.edges[min(i, len(self.edges) - 1)])
