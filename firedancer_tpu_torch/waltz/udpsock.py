"""UDP sockets packet engine (ref: src/waltz/udpsock/fd_udpsock.c — the
no-XDP fallback aio; here it is the primary backend, same burst API).

One recvfrom syscall per datagram over a nonblocking socket, drained up to
`burst` per poll.  (The reference's batching lever is AF_XDP ring bursts; a
recvmmsg/zero-copy backend can replace this class behind the same API if
socket syscalls ever become the ingest bottleneck — today the device
round-trip dominates.)

The port's own copy of firedancer_tpu/waltz/udpsock.py.
"""

import errno
import socket

from .aio import Aio, Pkt


class UdpSock:
    MTU = 1500  # wire datagram cap; Solana txn MTU is 1232 (fd_txn.h:92)

    def __init__(self, bind_ip: str = "0.0.0.0", bind_port: int = 0,
                 burst: int = 64, rcvbuf: int = 1 << 20,
                 mutable: bool = False):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
        self.sock.bind((bind_ip, bind_port))
        self.sock.setblocking(False)
        self.burst = burst
        # mutable=True: recv into fresh bytearrays (QUIC burst decrypt
        # runs in place in the rx buffer).  Default stays bytes — gossip/
        # repair parsers key dicts on payload slices, which must hash.
        self.mutable = mutable
        self.addr = self.sock.getsockname()

    @property
    def port(self) -> int:
        return self.addr[1]

    def recv_burst(self) -> list[Pkt]:
        """Drain up to `burst` datagrams; returns [] when the socket is dry.

        With mutable=True each datagram lands in its own fresh bytearray
        (recvfrom_into, no bytes->bytearray round trip): QUIC burst
        decrypt runs IN PLACE in the rx buffer, so payloads must be
        mutable and uniquely owned."""
        out = []
        if self.mutable:
            for _ in range(self.burst):
                buf = bytearray(self.MTU)
                try:
                    n, addr = self.sock.recvfrom_into(buf, self.MTU)
                except (BlockingIOError, InterruptedError):
                    break
                except OSError as e:
                    if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                        break
                    raise
                del buf[n:]
                out.append(Pkt(buf, addr))
            return out
        for _ in range(self.burst):
            try:
                data, addr = self.sock.recvfrom(self.MTU)
            except (BlockingIOError, InterruptedError):
                break
            except OSError as e:
                if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                    break
                raise
            out.append(Pkt(data, addr))
        return out

    def send_burst(self, pkts: list[Pkt]) -> int:
        sent = 0
        for p in pkts:
            try:
                self.sock.sendto(p.payload, p.addr)
                sent += 1
            except (BlockingIOError, InterruptedError):
                break
        return sent

    def aio(self) -> Aio:
        return Aio(self.send_burst)

    def close(self):
        self.sock.close()
