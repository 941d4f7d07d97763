"""Base58 codec (Bitcoin alphabet), host-side: the port's own copy of
firedancer_tpu/ballet/base58.py's general codec (ref: src/ballet/base58/),
which the pack scheduler uses for the built-in program ids.
"""

_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_INDEX = {c: i for i, c in enumerate(_ALPHABET)}


def encode(data: bytes) -> str:
    """General base58 encode (leading zero bytes -> leading '1's)."""
    n_zeros = len(data) - len(data.lstrip(b"\0"))
    num = int.from_bytes(data, "big")
    out = []
    while num:
        num, rem = divmod(num, 58)
        out.append(_ALPHABET[rem])
    return "1" * n_zeros + "".join(reversed(out))


def decode(s: str, want_len: int | None = None) -> bytes:
    """General base58 decode; raises ValueError on bad chars or wrong len."""
    num = 0
    for c in s:
        try:
            num = num * 58 + _INDEX[c]
        except KeyError:
            raise ValueError(f"invalid base58 character {c!r}") from None
    n_zeros = len(s) - len(s.lstrip("1"))
    body = num.to_bytes((num.bit_length() + 7) // 8, "big") if num else b""
    out = b"\0" * n_zeros + body
    if want_len is not None and len(out) != want_len:
        raise ValueError(f"decoded length {len(out)} != {want_len}")
    return out
