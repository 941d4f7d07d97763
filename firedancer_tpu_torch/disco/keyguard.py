"""Key isolation (ref: src/disco/keyguard — fd_keyguard.h:4-23, fd_keyload.c,
fd_keyguard_client.c); the port's own copy of
firedancer_tpu/disco/keyguard.py.

Only the sign tile's process ever maps the private key; every other tile
sends role-typed signing requests over a dedicated link pair and receives a
64-byte signature back.  The sign tile validates that the payload shape is
legal for the requesting role before signing — a compromised requester tile
must not be able to extract signatures over arbitrary messages of another
role's type (the reference's core keyguard property).

Roles (fd_keyguard.h:19-23): leader (shred merkle roots), voter (vote txns),
gossip (crds values), tls (handshake transcripts), repair (request
pre-images).  Keypair files are the JAX package's JSON format, so a key
written by either package is read by the other.
"""

import json
import os
import time

from ..tango.ring import Cnc

ROLE_LEADER = 1    # 32-byte shred merkle root
ROLE_VOTER = 2     # serialized vote txn message
ROLE_GOSSIP = 3    # crds value pre-image
ROLE_TLS = 4       # TLS 1.3 transcript hash pre-image (130 bytes)
ROLE_REPAIR = 5    # domain-prefixed repair request pre-image

# domain || from[32] | type u8 | nonce u32 | slot u64 | idx u32.  The
# domain prefix makes the set disjoint by construction: no CRDS signable
# can start with it without grinding an ed25519 pubkey whose first 13
# bytes match (~2^104 work).
_REPAIR_DOMAIN = b"FDTPU_REPAIR\0"
_REPAIR_PREIMAGE_SZ = len(_REPAIR_DOMAIN) + 49


def _is_repair_preimage(msg: bytes) -> bool:
    return (len(msg) == _REPAIR_PREIMAGE_SZ
            and msg.startswith(_REPAIR_DOMAIN)
            and msg[len(_REPAIR_DOMAIN) + 32] in (0, 1, 2))


SIG_SZ = 64


def keypair_write(path: str, seed: bytes, pubkey: bytes):
    """Write an Agave-style JSON keypair file: 64 ints (seed || pubkey)."""
    with open(path, "w") as f:
        json.dump(list(seed + pubkey), f)
    os.chmod(path, 0o600)


def keypair_read(path: str) -> tuple[bytes, bytes]:
    """(seed, pubkey) from a JSON keypair file (ref fd_keyload_load: the
    reference also mlocks and guards the page; process isolation is our
    boundary here)."""
    with open(path) as f:
        raw = bytes(json.load(f))
    if len(raw) != 64:
        raise ValueError(f"bad keypair file {path}: {len(raw)} bytes")
    return raw[:32], raw[32:]


_TLS_PREFIX = b"\x20" * 64  # CertificateVerify context padding (RFC 8446)


def _parses_as_txn_message(msg: bytes):
    """Parse `msg` as the signed message region of a txn by prepending the
    signature vector its header demands (dummy sig bytes — the parse is
    structural); returns (txn, payload) or None."""
    from ..ballet import txn as txn_lib

    if not msg:
        return None
    # legacy message: byte 0 is num_required_signatures; versioned (V0+):
    # byte 0 is 0x80|version and num_required_signatures is byte 1
    if msg[0] & 0x80:
        if len(msg) < 2:
            return None
        n = msg[1]
    else:
        n = msg[0]
    if n == 0 or n > 12:  # FD_TXN_ACTUAL_SIG_MAX
        return None
    payload = bytes([n]) + bytes(64 * n) + msg
    try:
        return txn_lib.parse(payload), payload
    except txn_lib.TxnParseError:
        return None


def role_payload_ok(role: int, msg: bytes) -> bool:
    """The sign tile's request filter (fd_keyguard_payload_authorize
    analogue).  The sets accepted per role are mutually disjoint so a
    compromised tile of one role can never obtain a signature that is
    meaningful to another role's verifiers:

      LEADER  — exactly a 20/32-byte merkle root
      VOTER   — a txn message whose every instruction targets the vote
                program (so it can never move funds or sign gossip data)
      GOSSIP  — bounded blob that is NOT a merkle-root length, NOT a
                parseable txn message, NOT TLS-context-shaped, NOT a
                repair request pre-image
      TLS     — CertificateVerify content: 64 pad spaces + label + hash
      REPAIR  — exactly the 49-byte repair request pre-image
    """
    if role == ROLE_LEADER:
        return len(msg) in (20, 32)
    if role == ROLE_VOTER:
        from ..ballet.pack import VOTE_PROG_ID

        parsed = _parses_as_txn_message(msg)
        if parsed is None:
            return False
        t, payload = parsed
        if not t.instrs:
            return False
        addrs = t.account_addrs(payload)
        return all(addrs[ix.program_id] == VOTE_PROG_ID for ix in t.instrs)
    if role == ROLE_GOSSIP:
        if not 0 < len(msg) <= 1232 or len(msg) in (20, 32):
            return False
        # exclude the repair DOMAIN (not a length shape): CRDS signables
        # of any length stay signable — only a blob claiming the repair
        # signing domain is refused
        if msg.startswith(_TLS_PREFIX) or msg.startswith(_REPAIR_DOMAIN):
            return False
        return _parses_as_txn_message(msg) is None
    if role == ROLE_TLS:
        return 64 < len(msg) <= 130 and msg.startswith(_TLS_PREFIX)
    if role == ROLE_REPAIR:
        return _is_repair_preimage(msg)
    return False


class KeyguardDown(RuntimeError):
    """The sign tile will serve no more requests: it exited, failed or
    parked after a drain.  Raised instead of waiting out the timeout."""


# cnc signals of a sign tile that serves nothing more
_DOWN = (Cnc.SIGNAL_FAIL, Cnc.SIGNAL_DRAINED)


class KeyguardClient:
    """Synchronous signing RPC over a request/response link pair
    (fd_keyguard_client_sign): publish role||msg on `req_out`, spin on the
    `resp_link` mcache for the signature frag.  One request in flight.

    The response link has no reliable consumer, so the sign tile publishes
    on it without waiting for credits; the client reads it under the
    mcache seqlock (re-checked after the payload copy) and resyncs to the
    producer's cursor on an overrun.  While it waits it watches the cnc of
    every tile that consumes `req_out`: when all of them serve nothing
    more (FAIL, DRAINED, or BOOT once seen running or while this tile
    halts, as at a halt the sign tile exits to BOOT) it raises
    KeyguardDown rather than time out, so the caller can count what it
    could not sign."""

    def __init__(self, ctx, req_out: str, resp_link: str):
        self._ctx = ctx
        self._out = ctx.out_index(req_out)
        jl = ctx.topo.links[resp_link]
        self._mc, self._dc = jl.mcache, jl.dcache
        self._seq = self._mc.seq_query()
        self._own = ctx.topo.cnc[ctx.tile.name]
        self._signers = [ctx.topo.cnc[t.name] for t in ctx.topo.spec.tiles
                         if any(il.link == req_out for il in t.in_links)]
        self._seen_up = False

    def halting(self) -> bool:
        """This tile is coming down: HALT on its cnc, or asked to halt."""
        return (self._ctx.halted
                or self._own.signal_query() == Cnc.SIGNAL_HALT)

    def _down(self) -> bool:
        sigs = [c.signal_query() for c in self._signers]
        if any(s == Cnc.SIGNAL_RUN for s in sigs):
            self._seen_up = True
            return False
        boot_down = self._seen_up or self.halting()
        return all(s in _DOWN or (s == Cnc.SIGNAL_BOOT and boot_down)
                   for s in sigs)

    def _poll(self):
        """The response at the cursor, or None while it is not there."""
        rc, meta = self._mc.query(self._seq)
        if rc == 0:
            sz = int(meta["sz"])
            sig = self._dc.read(int(meta["chunk"]), sz)
            rc2, _ = self._mc.query(self._seq)  # seqlock re-check
            if rc2 != 0:
                raise RuntimeError("keyguard response overrun")
            self._seq += 1
            if sz != SIG_SZ:
                raise RuntimeError("keyguard refused request")
            return sig
        if rc == 1:  # overrun: resync (should not happen, one in flight)
            self._seq = self._mc.seq_query()
        return None

    def sign(self, role: int, msg: bytes, timeout_s: float = 10.0) -> bytes:
        if self._down():
            raise KeyguardDown("the sign tile serves no more requests")
        if self._ctx.publish(bytes([role]) + msg, sig=role,
                             out=self._out) < 0:
            raise KeyguardDown("halted while the request link was full")
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            sig = self._poll()
            if sig is not None:
                return sig
            if self._down():
                # it may have answered just before it went down
                sig = self._poll()
                if sig is not None:
                    return sig
                raise KeyguardDown("the sign tile went down before it "
                                   "answered")
            time.sleep(20e-6)
        raise TimeoutError("keyguard sign timed out")
