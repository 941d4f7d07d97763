"""Abstract async packet-burst interface (ref: src/waltz/aio/fd_aio.c).

An aio is a callback taking a burst of packets; transmitters call
send_burst, receivers poll recv_burst.  Everything above the wire (net
tile, quic tile) talks bursts of (payload, addr) so the socket backend can
be swapped for a kernel-bypass one without touching tiles.

The port's own copy of firedancer_tpu/waltz/aio.py.
"""

from dataclasses import dataclass
from typing import Callable, Iterable


@dataclass(frozen=True)
class Pkt:
    payload: bytes
    addr: tuple  # (ip, port) peer


class Aio:
    """Burst sink (fd_aio_t: one send_func taking a packet batch)."""

    def __init__(self, send_func: Callable[[list[Pkt]], int]):
        self._send = send_func

    def send(self, pkts: Iterable[Pkt]) -> int:
        """Returns packets accepted (backpressure = partial count)."""
        return self._send(list(pkts))
