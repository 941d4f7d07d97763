"""Batched SHA-256 on torch tensors: variable-length messages, and the
fixed 32- and 64-byte forms the PoH chain hashes.

Counterpart of firedancer_tpu/ops/sha256.py and the plain version the
PoH and mixin-tree kernels (csrc/poh_spans.cu, csrc/mixin_tree.cu,
through csrc/sha256.cuh) are held against.  Bytes go in and out as
uint8; a word is a uint32 value held in an int64 tensor (torch has no
uint32 addition), so every sum is masked back to 32 bits.  State and
schedule planes are (8, batch) and (16, batch), as in the JAX package.

The constant blocks keep the JAX package's shortcut: the second block of
a 64-byte message is fully constant, so its schedule plus the round
constants is one host table (PAD64_WK) and the pad block runs 64 rounds
with no schedule; the back half of a 32-byte message's only block is the
constant tail PAD32_TAILW.
"""

import functools

import torch

from .sha512 import _iroot, _primes

_M32 = 0xFFFFFFFF

# H0 = frac(sqrt(p)), K = frac(cbrt(p)) to 32 bits over the first 8/64
# primes
H0 = [_iroot(p << 64, 2) & _M32 for p in _primes(8)]
K = [_iroot(p << 96, 3) & _M32 for p in _primes(64)]


def _np_schedule(w16: list[int]) -> list[int]:
    """Host message schedule of one constant block: 16 -> 64 words."""

    def rotr(x, r):
        return ((x >> r) | (x << (32 - r))) & _M32

    w = [int(x) for x in w16]
    for i in range(16, 64):
        s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M32)
    return w


# the constant second block of a 64-byte message: 0x80, zeros, bit
# length 512 (0x200) big-endian in the last 8 bytes
_PAD64_WORDS = [0x80000000] + [0] * 14 + [0x200]
PAD64_WK = [(w + k) & _M32 for w, k in zip(_np_schedule(_PAD64_WORDS), K)]
# message words 8..15 of a 32-byte message's block: 0x80, bit length 256
PAD32_TAILW = [0x80000000, 0, 0, 0, 0, 0, 0, 0x100]


@functools.lru_cache(maxsize=None)
def _const(name: str, device: torch.device) -> torch.Tensor:
    vals = {"H0": H0, "PAD64_WK": PAD64_WK,
            "PAD32_TAILW": PAD32_TAILW}[name]
    return torch.tensor(vals, dtype=torch.int64, device=device)


def _h0_dev(device):
    return _const("H0", torch.device(device))


def _pad64_wk_dev(device):
    return _const("PAD64_WK", torch.device(device))


def _pad32_tailw_dev(device):
    return _const("PAD32_TAILW", torch.device(device))


def _rotr(x, r: int):
    return ((x >> r) | (x << (32 - r))) & _M32


def _words(b):
    """uint8 (batch, 4k) -> int64 (k, batch) big-endian words."""
    batch = b.shape[0]
    v = b.reshape(batch, -1, 4).to(torch.int64)
    return ((v[:, :, 0] << 24) | (v[:, :, 1] << 16) | (v[:, :, 2] << 8)
            | v[:, :, 3]).T


def _round(st, wk):
    a, b_, c, d, e, f, g, h = st
    s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
    ch = (e & f) ^ (~e & g & _M32)
    t1 = h + s1 + ch + wk
    s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
    maj = (a & b_) ^ (a & c) ^ (b_ & c)
    return [(t1 + s0 + maj) & _M32, a, b_, c, (d + t1) & _M32, e, f, g]


def _compress_w16(state, w16):
    """SHA-256 compression from a 16-word schedule window.  state: int64
    (8, batch); w16: int64 (16, batch).  Returns the new (8, batch)."""
    w = list(w16.unbind(0))
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M32)
    st = list(state.unbind(0))
    for t in range(64):
        st = _round(st, w[t] + K[t])
    return (state + torch.stack(st)) & _M32


def _compress_block(state, blk):
    """One compression.  state: int64 (8, batch); blk: uint8 (batch, 64)."""
    return _compress_w16(state, _words(blk))


def _compress_const_block(state, wk):
    """Compression of a block whose content is constant: `wk` is its
    precomputed (64,) schedule-plus-round-constant table."""
    st = list(state.unbind(0))
    for t in range(64):
        st = _round(st, wk[t])
    return (state + torch.stack(st)) & _M32


def _state0(batch: int, device):
    return _h0_dev(device)[:, None].expand(8, batch).clone()


def pad_messages(msgs, lengths, max_blocks: int):
    """SHA-256 padding.  msgs: uint8 (batch, maxlen); lengths: (batch,).
    Returns (padded uint8 (batch, max_blocks * 64), nblocks int64)."""
    batch, maxlen = msgs.shape
    total = max_blocks * 64
    ln = lengths.to(torch.int64)[:, None]
    nblocks = (lengths.to(torch.int64) + 9 + 63) // 64
    j = torch.arange(total, device=msgs.device)[None, :]
    src = torch.zeros((batch, total), dtype=torch.int64, device=msgs.device)
    src[:, :maxlen] = msgs.to(torch.int64)
    body = torch.where(j < ln, src, 0)
    body = torch.where(j == ln, 0x80, body)
    # 64-bit big-endian bit length in the last 8 bytes of the last block;
    # a message bit length is < 2^32, so only the low 4 bytes are set
    fpos = j - (nblocks[:, None] * 64 - 8)
    shift = (7 - fpos) * 8
    lbyte = torch.where((shift < 32) & (shift >= 0),
                        ((ln * 8) >> shift.clamp(0, 31)) & 0xFF, 0)
    padded = torch.where((fpos >= 0) & (fpos < 8), lbyte, body)
    return padded.to(torch.uint8), nblocks


def state_to_bytes(state):
    """int64 (8, batch) words -> uint8 (batch, 32), big-endian."""
    sh = torch.tensor([24, 16, 8, 0], device=state.device)
    return ((state.T[:, :, None] >> sh) & 0xFF).reshape(
        state.shape[1], 32).to(torch.uint8)


def sha256(msgs, lengths, max_blocks: int | None = None):
    """Batched SHA-256.  msgs: uint8 (batch, maxlen); lengths: (batch,).
    Returns digests uint8 (batch, 32)."""
    batch, maxlen = msgs.shape
    if max_blocks is None:
        max_blocks = (maxlen + 9 + 63) // 64
    padded, nblocks = pad_messages(msgs, lengths, max_blocks)
    blocks = padded.reshape(batch, max_blocks, 64)
    state = _state0(batch, msgs.device)
    for blk in range(max_blocks):
        new = _compress_block(state, blocks[:, blk])
        state = torch.where((blk < nblocks)[None, :], new, state)
    return state_to_bytes(state)


def fixed32_words(st):
    """A PoH append on words: int64 (8, batch) -> (8, batch), the one
    block's back half the constant tail PAD32_TAILW."""
    batch = st.shape[1]
    tail = _pad32_tailw_dev(st.device)[:, None].expand(8, batch)
    return _compress_w16(_state0(batch, st.device), torch.cat([st, tail], 0))


def fixed64_words(st, mix):
    """A PoH mixin on words: SHA-256(st || mix), each int64 (8, batch):
    the message block, then the constant pad block from its table."""
    state = _compress_w16(_state0(st.shape[1], st.device),
                          torch.cat([st, mix], 0))
    return _compress_const_block(state, _pad64_wk_dev(st.device))


def bytes_to_state(b):
    """uint8 (batch, 32) -> int64 (8, batch) big-endian words."""
    return _words(b)


def sha256_fixed64(msgs64):
    """SHA-256 of 64-byte messages (the PoH mixin and merkle interior
    shape).  uint8 (batch, 64) -> uint8 (batch, 32)."""
    return state_to_bytes(fixed64_words(_words(msgs64[:, :32]),
                                        _words(msgs64[:, 32:])))


def sha256_fixed32(msgs32):
    """SHA-256 of 32-byte messages (a PoH append).  (batch, 32) ->
    (batch, 32)."""
    return state_to_bytes(fixed32_words(_words(msgs32)))
