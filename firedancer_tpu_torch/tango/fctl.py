"""Credit-based flow controller (ref: src/tango/fctl/fd_fctl.c); the port's
own copy of firedancer_tpu/tango/fctl.py.

A producer publishing into an mcache has cr_max credits (the ring depth);
each RELIABLE consumer advertises its progress through an fseq, and the
producer's available credit is the minimum over consumers of

    cr_max - (seq_produced - seq_consumer_seen)

i.e. it may run at most cr_max frags ahead of the slowest reliable
consumer.  Credits are only refreshed during housekeeping (reading N
consumer cachelines per frag would defeat the point); between refreshes
the producer decrements a local counter.  The controller also charges a
`slow` diagnostic to the consumer that set the minimum when the producer
is backpressured — how the reference's monitor attributes stalls
(src/tango/fctl/fd_fctl.h receiver diag).
"""

import time

from dataclasses import dataclass


@dataclass
class _Rx:
    fseq: object  # anything with .query() -> int and .diag_add(idx, delta)
    slow_diag_idx: int | None = None


class Fctl:
    """Producer-side credit controller over reliable receivers."""

    # matches FSeq.DIAG_SLOW_CNT in tango/ring.py (tango.cpp layout)
    DIAG_SLOW_CNT = 6

    def __init__(self, cr_max: int, cr_resume: int | None = None,
                 cr_refill: int | None = None):
        """cr_max: max credits (<= mcache depth).  cr_resume: credits at
        which a backpressured producer resumes (default 2/3 cr_max);
        cr_refill: min credits below which housekeeping tries a refresh
        (default cr_max/2)."""
        if cr_max < 1:
            raise ValueError("cr_max must be >= 1")
        self.cr_max = cr_max
        self.cr_resume = cr_resume or max(1, (2 * cr_max) // 3)
        self.cr_refill = cr_refill or max(1, cr_max // 2)
        self._rx: list[_Rx] = []
        self.cr_avail = cr_max
        self.in_backp = False
        self.backp_cnt = 0       # backpressure entries
        self.backp_exit_cnt = 0  # backpressure exits (resumes)
        self.stall_ns = 0        # total ns spent in backpressure
        self._backp_t0 = 0

    def rx_add(self, fseq, slow_diag_idx: int | None = DIAG_SLOW_CNT) -> "Fctl":
        self._rx.append(_Rx(fseq, slow_diag_idx))
        return self

    def rx_evict(self, fseq) -> bool:
        """Drop a receiver from credit control (its tile is gone and will
        not be respawned): the producer stops waiting on its line entirely.
        Returns True if the receiver was registered."""
        for rx in self._rx:
            if rx.fseq is fseq:
                self._rx.remove(rx)
                return True
        return False

    @staticmethod
    def evict_dead_consumer(fseq, mcache) -> int:
        """Dead-consumer credit eviction: fast-forward the corpse's fseq to
        the producer cursor so `cr_max - (seq - seen)` refills.

        This is the supervisor-side half of tile respawn — frags published
        while the consumer is down are acked on its behalf (and lost to
        it), which is exactly the reference's unreliable-consumer overrun
        semantics applied for the duration of the outage.  The respawned
        tile resumes from the evicted cursor, so no frag is ever processed
        twice.  Returns the cursor written."""
        cur = mcache.seq_query()
        reset = getattr(fseq, "reset", None) or fseq.update
        reset(cur)
        return cur

    @property
    def rx_cnt(self) -> int:
        return len(self._rx)

    def cr_query(self, seq_produced: int) -> int:
        """Recompute available credits from every receiver's fseq; charges
        the slow diag to the limiting receiver if the producer is starved
        (< cr_resume while in backpressure)."""
        cr = self.cr_max
        slowest = None
        for rx in self._rx:
            seen = rx.fseq.query()
            avail = self.cr_max - ((seq_produced - seen) & ((1 << 64) - 1))
            if avail < cr:
                cr = avail
                slowest = rx
        cr = max(0, cr)
        if self.in_backp and cr < self.cr_resume and slowest is not None \
                and slowest.slow_diag_idx is not None:
            slowest.fseq.diag_add(slowest.slow_diag_idx)
        return cr

    def tx_cr_update(self, seq_produced: int) -> int:
        """Housekeeping-time credit refresh (fd_fctl_tx_cr_update): refill
        cr_avail when it has drained below cr_refill, applying resume
        hysteresis when backpressured."""
        if self.cr_avail < self.cr_refill or self.in_backp:
            cr = self.cr_query(seq_produced)
            if self.in_backp:
                if cr >= self.cr_resume:
                    self.in_backp = False
                    self.backp_exit_cnt += 1
                    self.stall_ns += time.monotonic_ns() - self._backp_t0
                    self.cr_avail = cr
            else:
                self.cr_avail = cr
        return self.cr_avail

    def consume(self, n: int = 1) -> bool:
        """Spend credits for n publishes; returns False (and enters
        backpressure) if there aren't enough."""
        if self.cr_avail < n:
            if not self.in_backp:
                self.in_backp = True
                self.backp_cnt += 1
                self._backp_t0 = time.monotonic_ns()
            return False
        self.cr_avail -= n
        return True
