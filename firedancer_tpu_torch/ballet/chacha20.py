"""ChaCha20 stream cipher + ChaCha20Rng, host-side (numpy block core).

Reference role: src/ballet/chacha20/ — (a) QUIC packet protection suite
option, (b) the deterministic RNG behind stake-weighted sampling: Solana's
leader schedule and turbine trees draw from rand_chacha's ChaCha20Rng
seeded with an epoch-derived 32-byte seed, and consensus requires our
stream to match it bit-for-bit (fd_chacha20_rng).

The block function is numpy-vectorized over counters (many blocks per call)
— the host analogue of the reference's AVX lanes; the RNG's consumers
(wsample) pull 64-bit words.

The port's own copy of firedancer_tpu/ballet/chacha20.py.
"""

import numpy as np

_SIGMA = np.frombuffer(b"expand 32-byte k", dtype="<u4")


def _quarter(x, a, b, c, d):
    x[a] += x[b]
    x[d] = np.bitwise_xor(x[d], x[a])
    x[d] = (x[d] << 16) | (x[d] >> 16)
    x[c] += x[d]
    x[b] = np.bitwise_xor(x[b], x[c])
    x[b] = (x[b] << 12) | (x[b] >> 20)
    x[a] += x[b]
    x[d] = np.bitwise_xor(x[d], x[a])
    x[d] = (x[d] << 8) | (x[d] >> 24)
    x[c] += x[d]
    x[b] = np.bitwise_xor(x[b], x[c])
    x[b] = (x[b] << 7) | (x[b] >> 25)


def chacha20_blocks(key: bytes, nonce: bytes, counter0: int, n_blocks: int) -> bytes:
    """Keystream for n_blocks consecutive 64-byte blocks, all lanes at once.

    nonce is 12 bytes (IETF) with a 32-bit counter, or 8 bytes (djb/rand_chacha)
    with a 64-bit counter.
    """
    k = np.frombuffer(key, dtype="<u4")
    if len(nonce) == 12:
        ctr_words = 1
        non = np.frombuffer(nonce, dtype="<u4")
    elif len(nonce) == 8:
        ctr_words = 2
        non = np.frombuffer(nonce, dtype="<u4")
    else:
        raise ValueError("nonce must be 8 or 12 bytes")

    state = np.zeros((16, n_blocks), dtype=np.uint32)
    state[0:4] = _SIGMA[:, None]
    state[4:12] = k[:, None]
    ctrs = counter0 + np.arange(n_blocks, dtype=np.uint64)
    state[12] = ctrs.astype(np.uint32)
    if ctr_words == 2:
        state[13] = (ctrs >> np.uint64(32)).astype(np.uint32)
        state[14:16] = non[:, None]
    else:
        state[13:16] = non[:, None]

    with np.errstate(over="ignore"):
        x = state.copy()
        for _ in range(10):  # 20 rounds = 10 double rounds
            _quarter(x, 0, 4, 8, 12)
            _quarter(x, 1, 5, 9, 13)
            _quarter(x, 2, 6, 10, 14)
            _quarter(x, 3, 7, 11, 15)
            _quarter(x, 0, 5, 10, 15)
            _quarter(x, 1, 6, 11, 12)
            _quarter(x, 2, 7, 8, 13)
            _quarter(x, 3, 4, 9, 14)
        x += state
    # per block: 16 words little-endian
    return x.T.astype("<u4").tobytes()


def chacha20_encrypt(key: bytes, nonce: bytes, counter0: int, data: bytes) -> bytes:
    n_blocks = (len(data) + 63) // 64
    ks = chacha20_blocks(key, nonce, counter0, n_blocks)[: len(data)]
    return (
        np.bitwise_xor(
            np.frombuffer(data, dtype=np.uint8), np.frombuffer(ks, dtype=np.uint8)
        )
    ).tobytes()


class ChaCha20Rng:
    """Deterministic RNG matching rand_chacha's ChaCha20Rng (8-byte zero
    nonce, 64-bit block counter from 0), the stream Solana's leader schedule
    samples from (fd_chacha20_rng.h)."""

    REFILL_BLOCKS = 64  # refill granularity (4 KiB of keystream)

    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("seed must be 32 bytes")
        self.seed = seed
        self.counter = 0
        self._buf = b""
        self._off = 0

    def _refill(self):
        self._buf = chacha20_blocks(
            self.seed, b"\0" * 8, self.counter, self.REFILL_BLOCKS
        )
        self.counter += self.REFILL_BLOCKS
        self._off = 0

    def next_u32(self) -> int:
        if self._off + 4 > len(self._buf):
            self._refill()
        v = int.from_bytes(self._buf[self._off : self._off + 4], "little")
        self._off += 4
        return v

    def next_u64(self) -> int:
        if self._off + 8 > len(self._buf):
            self._refill()
        v = int.from_bytes(self._buf[self._off : self._off + 8], "little")
        self._off += 8
        return v

    # rejection-zone modes (fd_chacha20rng.h:23-24 / Rust rand 0.7
    # UniformInt<u64>): MOD = the ahead-of-time Uniform distribution
    # (largest k, used by WeightedIndex -> leader schedules), SHIFT =
    # sample_single's power-of-two zone (used by Turbine's shuffle)
    MODE_MOD = 1
    MODE_SHIFT = 2

    def roll_u64(self, n: int, mode: int = MODE_MOD) -> int:
        """Uniform draw in [0, n): Lemire multiply-high bounded rand with
        rand-0.7-exact rejection zones (fd_chacha20rng_ulong_roll) — the
        map is hi64(v * n), accepting only draws whose lo64 falls in the
        mode's zone.  Wire-critical: leader schedules (MODE_MOD) and
        turbine trees (MODE_SHIFT) must consume the identical stream as
        Agave/the reference or every derived schedule diverges."""
        if n <= 0:
            raise ValueError("n must be positive")
        if mode == self.MODE_MOD:
            zone = ((1 << 64) - 1) - ((1 << 64) - n) % n
        else:
            zone = (n << (63 - (n.bit_length() - 1))) - 1
        while True:
            v = self.next_u64() * n
            if (v & ((1 << 64) - 1)) <= zone:
                return v >> 64
