"""Solana transaction wire-format parser.

The port's own copy of firedancer_tpu/ballet/txn.py (the port imports
nothing of the JAX package).  Validation rules are consensus-identical to
the reference's fd_txn_parse (src/ballet/txn/fd_txn_parse.c:80-236); the
descriptor mirrors fd_txn_t (src/ballet/txn/fd_txn.h:60-103): byte OFFSETS
into the original payload rather than copies, so signature/pubkey/message
extraction for the verify batch is zero-copy slicing.

Host code: the parser is a scalar loop per txn, as the reference's is;
the batch axis lives one level up, in the pipeline that packs many parsed
txns into fixed device shapes.
"""

from dataclasses import dataclass, field

from . import compact_u16 as cu16

# wire limits (fd_txn.h:35-108)
SIGNATURE_SZ = 64
PUBKEY_SZ = 32
ACCT_ADDR_SZ = 32
BLOCKHASH_SZ = 32
SIG_MAX = 127
ACTUAL_SIG_MAX = 12
ACCT_ADDR_MAX = 128
ADDR_TABLE_LOOKUP_MAX = 127
INSTR_MAX = 64
MTU = 1232
MIN_SERIALIZED_SZ = 134

VLEGACY = 0xFF
V0 = 0x00

_MIN_INSTR_SZ = 3
_MIN_ADDR_LUT_SZ = 34


class TxnParseError(ValueError):
    pass


@dataclass(frozen=True)
class Instr:
    """One instruction: offsets into the payload (fd_txn_instr_t)."""

    program_id: int
    acct_cnt: int
    data_sz: int
    acct_off: int
    data_off: int


@dataclass(frozen=True)
class AddrTableLookup:
    """One address-table lookup (fd_txn_acct_addr_lut_t)."""

    addr_off: int
    writable_cnt: int
    readonly_cnt: int
    writable_off: int
    readonly_off: int


@dataclass(frozen=True)
class Txn:
    """Parsed transaction descriptor (fd_txn_t, fd_txn.h:60-103)."""

    transaction_version: int
    signature_cnt: int
    signature_off: int
    message_off: int
    readonly_signed_cnt: int
    readonly_unsigned_cnt: int
    acct_addr_cnt: int
    acct_addr_off: int
    recent_blockhash_off: int
    addr_table_lookup_cnt: int
    addr_table_adtl_writable_cnt: int
    addr_table_adtl_cnt: int
    instrs: tuple[Instr, ...] = field(default_factory=tuple)
    addr_tables: tuple[AddrTableLookup, ...] = field(default_factory=tuple)

    # ------------------------------------------------- zero-copy extraction

    def signatures(self, payload: bytes) -> list[bytes]:
        o = self.signature_off
        return [
            payload[o + i * SIGNATURE_SZ : o + (i + 1) * SIGNATURE_SZ]
            for i in range(self.signature_cnt)
        ]

    def signer_pubkeys(self, payload: bytes) -> list[bytes]:
        """The first signature_cnt account addresses are the signers'
        pubkeys, in signature order (fd_txn.h account ordering)."""
        o = self.acct_addr_off
        return [
            payload[o + i * ACCT_ADDR_SZ : o + (i + 1) * ACCT_ADDR_SZ]
            for i in range(self.signature_cnt)
        ]

    def account_addrs(self, payload: bytes) -> list[bytes]:
        o = self.acct_addr_off
        return [
            payload[o + i * ACCT_ADDR_SZ : o + (i + 1) * ACCT_ADDR_SZ]
            for i in range(self.acct_addr_cnt)
        ]

    def message(self, payload: bytes) -> bytes:
        """The signed region: everything from message_off to the end."""
        return payload[self.message_off :]

    def recent_blockhash(self, payload: bytes) -> bytes:
        return payload[self.recent_blockhash_off : self.recent_blockhash_off + BLOCKHASH_SZ]

    def is_writable(self, idx: int) -> bool:
        """Static-account writability (message-level accounts only):
        writable-signed | writable-unsigned partition per fd_txn.h ordering."""
        if idx < self.signature_cnt:
            return idx < self.signature_cnt - self.readonly_signed_cnt
        return idx < self.acct_addr_cnt - self.readonly_unsigned_cnt


def fee_payer(payload: bytes):
    """The first static account address (the fee payer) without a full
    parse — just the fixed-offset header walk.  Returns None on any
    malformed header instead of raising: the sharded leader_pack tiles
    steer EVERY rx'd txn by fee payer before deciding whether to pay for
    a full parse, so a bad txn must cost O(1) on the non-owning shards
    (the owning shard's parse rejects it with the real error)."""
    try:
        nsig = payload[0]
        i = 1 + SIGNATURE_SZ * nsig
        # message header: 1 version byte + dup sig byte (v0) or the sig
        # count itself (legacy), then ro_signed + ro_unsigned
        i += 2 if payload[i] & 0x80 else 1
        i += 2
        cnt, used = cu16.decode(payload, i)
        i += used
        if cnt < 1 or i + ACCT_ADDR_SZ > len(payload):
            return None
        return payload[i : i + ACCT_ADDR_SZ]
    except (IndexError, ValueError):
        return None


def parse(payload: bytes, allow_zero_signatures: bool = False,
          partial: bool = False):
    """Parse + validate one serialized txn (fd_txn_parse semantics).

    Raises TxnParseError on any rule violation; trailing bytes are an error
    (the reference's !payload_sz_opt mode) unless partial=True, which
    returns (Txn, consumed) instead — the embedded-in-a-bincode-stream
    form gossip vote CRDS values use (the reference's payload_sz_opt
    mode, fd_txn_parse_core)."""
    n = len(payload)
    if n > MTU:
        raise TxnParseError(f"payload {n} > MTU {MTU}")
    i = 0

    def need(k: int):
        if k > n - i:
            raise TxnParseError(f"truncated at {i}, need {k}")

    def read_cu16() -> int:
        nonlocal i
        try:
            v, used = cu16.decode(payload, i)
        except ValueError as e:
            raise TxnParseError(str(e)) from e
        i += used
        return v

    need(1)
    signature_cnt = payload[i]
    i += 1
    if not allow_zero_signatures and not (1 <= signature_cnt <= SIG_MAX):
        raise TxnParseError(f"signature_cnt {signature_cnt}")
    need(SIGNATURE_SZ * signature_cnt)
    signature_off = i
    i += SIGNATURE_SZ * signature_cnt

    message_off = i
    need(1)
    header_b0 = payload[i]
    i += 1
    if header_b0 & 0x80:
        version = header_b0 & 0x7F
        if version != V0:
            raise TxnParseError(f"unknown txn version {version}")
        transaction_version = V0
        need(1)
        if payload[i] != signature_cnt:
            raise TxnParseError("header sig cnt != signature_cnt")
        i += 1
    else:
        transaction_version = VLEGACY
        if header_b0 != signature_cnt:
            raise TxnParseError("header sig cnt != signature_cnt")

    need(1)
    ro_signed_cnt = payload[i]
    i += 1
    if not allow_zero_signatures and not ro_signed_cnt < signature_cnt:
        raise TxnParseError("readonly_signed_cnt >= signature_cnt")
    need(1)
    ro_unsigned_cnt = payload[i]
    i += 1

    acct_addr_cnt = read_cu16()
    if not (signature_cnt <= acct_addr_cnt <= ACCT_ADDR_MAX):
        raise TxnParseError(f"acct_addr_cnt {acct_addr_cnt}")
    if signature_cnt + ro_unsigned_cnt > acct_addr_cnt:
        raise TxnParseError("signers + readonly unsigned > accounts")
    need(ACCT_ADDR_SZ * acct_addr_cnt)
    acct_addr_off = i
    i += ACCT_ADDR_SZ * acct_addr_cnt
    need(BLOCKHASH_SZ)
    recent_blockhash_off = i
    i += BLOCKHASH_SZ

    instr_cnt = read_cu16()
    if instr_cnt > INSTR_MAX:
        raise TxnParseError(f"instr_cnt {instr_cnt}")
    need(_MIN_INSTR_SZ * instr_cnt)
    # >0 instructions requires a non-fee-payer account for the program id
    if not allow_zero_signatures and not acct_addr_cnt > (1 if instr_cnt else 0):
        raise TxnParseError("no account available for program id")

    max_acct = 0
    instrs = []
    for _ in range(instr_cnt):
        need(_MIN_INSTR_SZ)
        program_id = payload[i]
        i += 1
        acct_cnt = read_cu16()
        need(acct_cnt)
        acct_off = i
        for k in range(acct_cnt):
            max_acct = max(max_acct, payload[i + k])
        i += acct_cnt
        data_sz = read_cu16()
        need(data_sz)
        data_off = i
        i += data_sz
        # program can't be the fee payer (acct 0) and can't come from a table
        if not allow_zero_signatures and not 0 < program_id < acct_addr_cnt:
            raise TxnParseError(f"program_id {program_id} out of range")
        instrs.append(Instr(program_id, acct_cnt, data_sz, acct_off, data_off))

    addr_tables = []
    adtl_writable = 0
    adtl = 0
    if transaction_version == V0:
        addr_table_cnt = read_cu16()
        if addr_table_cnt > ADDR_TABLE_LOOKUP_MAX:
            raise TxnParseError(f"addr_table_cnt {addr_table_cnt}")
        need(_MIN_ADDR_LUT_SZ * addr_table_cnt)
        for _ in range(addr_table_cnt):
            need(ACCT_ADDR_SZ)
            addr_off = i
            i += ACCT_ADDR_SZ
            writable_cnt = read_cu16()
            need(writable_cnt)
            writable_off = i
            i += writable_cnt
            readonly_cnt = read_cu16()
            need(readonly_cnt)
            readonly_off = i
            i += readonly_cnt
            if writable_cnt > ACCT_ADDR_MAX - acct_addr_cnt:
                raise TxnParseError("table writable_cnt too large")
            if readonly_cnt > ACCT_ADDR_MAX - acct_addr_cnt:
                raise TxnParseError("table readonly_cnt too large")
            if writable_cnt + readonly_cnt < 1:
                raise TxnParseError("empty address table lookup")
            addr_tables.append(
                AddrTableLookup(addr_off, writable_cnt, readonly_cnt, writable_off, readonly_off)
            )
            adtl_writable += writable_cnt
            adtl += writable_cnt + readonly_cnt

    if i != n and not partial:
        raise TxnParseError(f"{n - i} trailing bytes")
    if acct_addr_cnt + adtl > ACCT_ADDR_MAX:
        raise TxnParseError("total accounts > max")
    if not max_acct < acct_addr_cnt + adtl:
        raise TxnParseError(f"account index {max_acct} out of range")

    txn = Txn(
        transaction_version=transaction_version,
        signature_cnt=signature_cnt,
        signature_off=signature_off,
        message_off=message_off,
        readonly_signed_cnt=ro_signed_cnt,
        readonly_unsigned_cnt=ro_unsigned_cnt,
        acct_addr_cnt=acct_addr_cnt,
        acct_addr_off=acct_addr_off,
        recent_blockhash_off=recent_blockhash_off,
        addr_table_lookup_cnt=len(addr_tables),
        addr_table_adtl_writable_cnt=adtl_writable,
        addr_table_adtl_cnt=adtl,
        instrs=tuple(instrs),
        addr_tables=tuple(addr_tables),
    )
    return (txn, i) if partial else txn


# ---------------------------------------------------------------- generation
# Test/bench txn construction (the reference's fd_txn_generate,
# src/flamenco/txn/fd_txn_generate.c, serves the same role).


def build_unsigned(
    signer_pubkeys: list[bytes],
    recent_blockhash: bytes,
    instrs: list[tuple[int, bytes, bytes]],
    extra_accounts: list[bytes] | None = None,
    readonly_signed_cnt: int = 0,
    readonly_unsigned_cnt: int = 0,
    version: int = VLEGACY,
    lookups: list[tuple[bytes, bytes, bytes]] | None = None,
) -> bytes:
    """Serialize the MESSAGE (signed region) of a txn.

    instrs: list of (program_id_index, account_index_bytes, data).
    lookups (v0 only): list of (table_pubkey, writable_idx_bytes,
    readonly_idx_bytes) address-table lookups."""
    out = bytearray()
    nsig = len(signer_pubkeys)
    if version == V0:
        out.append(0x80)
        out.append(nsig)
    else:
        out.append(nsig)
    out.append(readonly_signed_cnt)
    out.append(readonly_unsigned_cnt)
    accounts = list(signer_pubkeys) + list(extra_accounts or [])
    out += cu16.encode(len(accounts))
    for a in accounts:
        if len(a) != ACCT_ADDR_SZ:
            raise ValueError(f"account address of {len(a)} bytes")
        out += a
    if len(recent_blockhash) != BLOCKHASH_SZ:
        raise ValueError(f"blockhash of {len(recent_blockhash)} bytes")
    out += recent_blockhash
    out += cu16.encode(len(instrs))
    for prog_idx, acct_idx, data in instrs:
        out.append(prog_idx)
        out += cu16.encode(len(acct_idx))
        out += acct_idx
        out += cu16.encode(len(data))
        out += data
    if version == V0:
        out += cu16.encode(len(lookups or []))
        for table_pk, wr_idx, ro_idx in lookups or []:
            if len(table_pk) != ACCT_ADDR_SZ:
                raise ValueError(f"table address of {len(table_pk)} bytes")
            out += table_pk
            out += cu16.encode(len(wr_idx)) + wr_idx
            out += cu16.encode(len(ro_idx)) + ro_idx
    else:
        if lookups:
            raise ValueError("lookups require a v0 message")
    return bytes(out)


def assemble(signatures: list[bytes], message: bytes) -> bytes:
    """sig list + message -> serialized txn."""
    out = bytearray([len(signatures)])
    for s in signatures:
        if len(s) != SIGNATURE_SZ:
            raise ValueError(f"signature of {len(s)} bytes")
        out += s
    out += message
    return bytes(out)
