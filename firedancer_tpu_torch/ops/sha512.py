"""Batched SHA-512 over variable-length messages on torch tensors.

Counterpart of firedancer_tpu/ops/sha512.py and the plain version of the
SHA-512 kernel (ops/sha512_kernel.py).  Words are whole 64-bit values in
int64 tensors: additions wrap in two's complement as the uint64 sums do,
and every right shift is made logical with a mask, since `>>` on int64
is arithmetic.
"""

import torch


def _iroot(n: int, k: int) -> int:
    """floor(n^(1/k)) by Newton iteration on Python ints."""
    x = 1 << ((n.bit_length() + k - 1) // k)
    while True:
        y = ((k - 1) * x + n // x ** (k - 1)) // k
        if y >= x:
            return x
        x = y


def _primes(n: int):
    out, c = [], 2
    while len(out) < n:
        if all(c % q for q in out):
            out.append(c)
        c += 1
    return out


# H0 = frac(sqrt(p)), K = frac(cbrt(p)) over the first 8 / 80 primes
H0 = [_iroot(p << 128, 2) & ((1 << 64) - 1) for p in _primes(8)]
K = [_iroot(p << 192, 3) & ((1 << 64) - 1) for p in _primes(80)]


def _s64(v: int) -> int:
    """uint64 value -> the int64 with the same bits."""
    return v - (1 << 64) if v >> 63 else v


def _shr(x, r: int):
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotr(x, r: int):
    return _shr(x, r) | (x << (64 - r))


def pad_messages(msgs, lengths, max_blocks: int):
    """SHA-512 padding.  msgs: uint8 (batch, maxlen); lengths: (batch,)
    in [0, maxlen].  Returns (padded uint8 (batch, max_blocks * 128),
    nblocks int64 (batch,))."""
    batch, maxlen = msgs.shape
    total = max_blocks * 128
    ln = lengths.to(torch.int64)[:, None]
    nblocks = (lengths.to(torch.int64) + 17 + 127) // 128
    j = torch.arange(total, device=msgs.device)[None, :]
    src = torch.zeros((batch, total), dtype=torch.int64, device=msgs.device)
    src[:, :maxlen] = msgs.to(torch.int64)
    body = torch.where(j < ln, src, 0)
    body = torch.where(j == ln, 0x80, body)
    # 128-bit big-endian bit length in the last 16 bytes of the last block
    fpos = j - (nblocks[:, None] * 128 - 16)
    shift = (15 - fpos) * 8
    lbyte = torch.where(shift < 64,
                        ((ln * 8) >> shift.clamp(0, 63)) & 0xFF, 0)
    padded = torch.where((fpos >= 0) & (fpos < 16), lbyte, body)
    return padded.to(torch.uint8), nblocks


def _compress(state, words):
    """One compression.  state: 8 int64 (batch,) words; words: 16 int64
    (batch,) big-endian message words."""
    w = list(words)
    for t in range(16, 80):
        s0 = _rotr(w[t - 15], 1) ^ _rotr(w[t - 15], 8) ^ _shr(w[t - 15], 7)
        s1 = _rotr(w[t - 2], 19) ^ _rotr(w[t - 2], 61) ^ _shr(w[t - 2], 6)
        w.append(w[t - 16] + s0 + w[t - 7] + s1)
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        s1 = _rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + _s64(K[t]) + w[t]
        s0 = _rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + s0 + maj
    return [s + n for s, n in zip(state, (a, b, c, d, e, f, g, h))]


def sha512(msgs, lengths, max_blocks: int | None = None):
    """Batched SHA-512.  msgs: uint8 (batch, maxlen); lengths: (batch,) in
    [0, maxlen].  Returns digests uint8 (batch, 64)."""
    batch, maxlen = msgs.shape
    if max_blocks is None:
        max_blocks = (maxlen + 17 + 127) // 128
    padded, nblocks = pad_messages(msgs, lengths, max_blocks)
    shifts = torch.arange(56, -8, -8, device=msgs.device)
    words = (padded.to(torch.int64).reshape(batch, max_blocks, 16, 8)
             << shifts).sum(-1)                      # (batch, nb, 16)
    state = [torch.full((batch,), _s64(v), dtype=torch.int64,
                        device=msgs.device) for v in H0]
    for blk in range(max_blocks):
        new = _compress(state, words[:, blk].unbind(1))
        active = blk < nblocks
        state = [torch.where(active, n, s) for s, n in zip(state, new)]
    st = torch.stack(state, 1)                       # (batch, 8)
    return ((st[:, :, None] >> shifts) & 0xFF).reshape(
        batch, 64).to(torch.uint8)
