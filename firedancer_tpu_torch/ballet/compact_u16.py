"""compact-u16: Solana's variable-length u16 wire encoding.

The port's own copy of firedancer_tpu/ballet/compact_u16.py, with the
reference decoder's semantics (src/ballet/txn/fd_compact_u16.h): 1-3
bytes, 7 value bits per continuation byte, minimal-length encoding
required (a trailing zero continuation byte or a 3rd byte > 3 is
illegal).
"""


def decode(buf: bytes, offset: int = 0) -> tuple[int, int]:
    """Decode one compact-u16 at `offset`.

    Returns (value, bytes_consumed).  Raises ValueError on truncation or a
    non-minimal/overflowing encoding (fd_cu16_dec_sz returning 0)."""
    n = len(buf)
    if offset >= n:
        raise ValueError("compact_u16: truncated")
    b0 = buf[offset]
    if b0 < 0x80:
        return b0, 1
    if offset + 1 >= n:
        raise ValueError("compact_u16: truncated")
    b1 = buf[offset + 1]
    if b1 < 0x80:
        if b1 == 0:
            raise ValueError("compact_u16: non-minimal encoding")
        return (b0 & 0x7F) | (b1 << 7), 2
    if offset + 2 >= n:
        raise ValueError("compact_u16: truncated")
    b2 = buf[offset + 2]
    if b2 == 0 or b2 > 3:
        raise ValueError("compact_u16: non-minimal or overflowing encoding")
    return (b0 & 0x7F) | ((b1 & 0x7F) << 7) | (b2 << 14), 3


def encode(val: int) -> bytes:
    """Minimal-length encoding of val in [0, 0xFFFF]."""
    if not 0 <= val <= 0xFFFF:
        raise ValueError(f"compact_u16: {val} out of range")
    if val < 0x80:
        return bytes([val])
    if val < 0x4000:
        return bytes([(val & 0x7F) | 0x80, val >> 7])
    return bytes([(val & 0x7F) | 0x80, ((val >> 7) & 0x7F) | 0x80, val >> 14])
