"""The port's key isolation (firedancer_tpu_torch/disco/keyguard.py and the
sign tile in disco/tiles.py) against the JAX package's.

- role_payload_ok on every input of tests/test_keyguard_roles.py (and the
  repair role's pre-image): the port's verdict equals the JAX package's
  and the verdict that test expects.
- Keypair files cross between the packages both ways, and the port's
  `fdtpuctl keys new|pubkey` writes and reads one.
- SignTile, the port's and the JAX one driven by the same recording ctx,
  publishes the same bytes and sig on the same out link for accepted and
  refused requests, with the same counters."""

import collections

import pytest

from firedancer_tpu.ballet import txn as jtxn
from firedancer_tpu.disco import keyguard as jkg
from firedancer_tpu.flamenco.types import SYSTEM_PROGRAM_ID, VOTE_PROGRAM_ID
from firedancer_tpu_torch.app import fdtpuctl
from firedancer_tpu_torch.disco import keyguard as pkg
from firedancer_tpu_torch.disco import tiles as ptiles
from firedancer_tpu_torch.ops import ed25519 as ped
from _torch_threads import one_torch_thread  # noqa: F401


def _message(program_id: bytes, n_ix: int = 1,
             version: int = jtxn.VLEGACY) -> bytes:
    """The message of tests/test_keyguard_roles.py's _message."""
    pub = ped.keypair_from_seed(b"\x07" * 32)[0]
    ixs = [(1, bytes([0]), b"\x01\x02\x03")] * n_ix
    return jtxn.build_unsigned([pub], b"\x42" * 32, ixs,
                               extra_accounts=[program_id], version=version)


_TLS_CLIENT = (b"\x20" * 64 + b"TLS 1.3, client CertificateVerify\x00"
               + b"h" * 32)
_TLS_SERVER = (b"\x20" * 64 + b"TLS 1.3, server CertificateVerify\x00"
               + b"h" * 32)
_REPAIR = pkg._REPAIR_DOMAIN + b"\x05" * 32 + b"\x01" + bytes(16)

# (role, payload maker, the verdict tests/test_keyguard_roles.py expects)
ROLE_CASES = {
    "leader_32": (pkg.ROLE_LEADER, lambda: b"\x01" * 32, True),
    "leader_20": (pkg.ROLE_LEADER, lambda: b"\x01" * 20, True),
    "leader_31": (pkg.ROLE_LEADER, lambda: b"\x01" * 31, False),
    "leader_empty": (pkg.ROLE_LEADER, lambda: b"", False),
    "leader_vote_msg": (pkg.ROLE_LEADER,
                        lambda: _message(VOTE_PROGRAM_ID), False),
    "voter_vote": (pkg.ROLE_VOTER, lambda: _message(VOTE_PROGRAM_ID), True),
    "voter_transfer": (pkg.ROLE_VOTER,
                       lambda: _message(SYSTEM_PROGRAM_ID), False),
    "voter_root": (pkg.ROLE_VOTER, lambda: b"\x01" * 32, False),
    "voter_text": (pkg.ROLE_VOTER, lambda: b"not a message", False),
    "gossip_crds": (pkg.ROLE_GOSSIP, lambda: b"some crds value preimage",
                    True),
    "gossip_root32": (pkg.ROLE_GOSSIP, lambda: b"\x01" * 32, False),
    "gossip_root20": (pkg.ROLE_GOSSIP, lambda: b"\x01" * 20, False),
    "gossip_transfer": (pkg.ROLE_GOSSIP,
                        lambda: _message(SYSTEM_PROGRAM_ID), False),
    "gossip_vote": (pkg.ROLE_GOSSIP, lambda: _message(VOTE_PROGRAM_ID),
                    False),
    "gossip_tls": (pkg.ROLE_GOSSIP, lambda: _TLS_SERVER, False),
    "gossip_empty": (pkg.ROLE_GOSSIP, lambda: b"", False),
    "gossip_long": (pkg.ROLE_GOSSIP, lambda: b"x" * 1233, False),
    "gossip_v0_transfer": (pkg.ROLE_GOSSIP, lambda: _message(
        SYSTEM_PROGRAM_ID, version=jtxn.V0), False),
    "voter_v0_vote": (pkg.ROLE_VOTER, lambda: _message(
        VOTE_PROGRAM_ID, version=jtxn.V0), True),
    "voter_v0_transfer": (pkg.ROLE_VOTER, lambda: _message(
        SYSTEM_PROGRAM_ID, version=jtxn.V0), False),
    "tls_certverify": (pkg.ROLE_TLS, lambda: _TLS_CLIENT, True),
    "tls_hash": (pkg.ROLE_TLS, lambda: b"h" * 32, False),
    "tls_no_label": (pkg.ROLE_TLS, lambda: b"\x20" * 64 + b"x" * 70, False),
    "unknown_0": (0, lambda: b"x", False),
    "unknown_99": (99, lambda: b"\x01" * 32, False),
    "repair_preimage": (pkg.ROLE_REPAIR, lambda: _REPAIR, True),
    "repair_bad_type": (pkg.ROLE_REPAIR,
                        lambda: _REPAIR[:45] + b"\x07" + _REPAIR[46:], False),
    "gossip_repair_domain": (pkg.ROLE_GOSSIP, lambda: _REPAIR, False),
}


@pytest.mark.parametrize("case", sorted(ROLE_CASES))
def test_role_payload_ok_equals_the_jax_filter(case):
    role, build, want = ROLE_CASES[case]
    msg = build()
    assert pkg.role_payload_ok(role, msg) == jkg.role_payload_ok(role, msg)
    assert pkg.role_payload_ok(role, msg) is want


def test_keypair_files_cross_between_the_packages(tmp_path):
    for i, (write, read) in enumerate(((pkg.keypair_write, jkg.keypair_read),
                                       (jkg.keypair_write, pkg.keypair_read))):
        seed = bytes([11 + i]) * 32
        pub = ped.keypair_from_seed(seed)[0]
        path = str(tmp_path / f"id{i}.json")
        write(path, seed, pub)
        assert read(path) == (seed, pub)
    (tmp_path / "bad.json").write_text("[1, 2, 3]")
    for read in (pkg.keypair_read, jkg.keypair_read):
        with pytest.raises(ValueError, match="3 bytes"):
            read(str(tmp_path / "bad.json"))


def test_fdtpuctl_keys_roundtrip(tmp_path, capsys):
    kpath = str(tmp_path / "id.json")
    assert fdtpuctl.main(["keys", "new", kpath]) == 0
    pub_hex = capsys.readouterr().out.strip()
    assert len(bytes.fromhex(pub_hex)) == 32
    assert fdtpuctl.main(["keys", "pubkey", kpath]) == 0
    assert capsys.readouterr().out.strip() == pub_hex
    # the JAX package reads the key, and it is the seed's public key
    seed, pub = jkg.keypair_read(kpath)
    assert pub.hex() == pub_hex == ped.keypair_from_seed(seed)[0].hex()


class _Metrics:
    def __init__(self):
        self.d = collections.Counter()

    def add(self, k, v=1):
        self.d[k] += v


class _Ctx:
    def __init__(self, cfg):
        self.cfg = cfg
        self.metrics = _Metrics()
        self.out = []

    def publish(self, payload, sig=0, out=0):
        self.out.append((bytes(payload), sig, out))
        return len(self.out) - 1


def test_sign_tile_equals_the_jax_tile(tmp_path):
    from firedancer_tpu.disco import tiles as jtiles
    seed = bytes(range(40, 72))
    kpath = str(tmp_path / "id.json")
    pkg.keypair_write(kpath, seed, ped.keypair_from_seed(seed)[0])
    reqs = [(0, bytes([pkg.ROLE_LEADER]) + b"\x33" * 32),
            (1, bytes([pkg.ROLE_LEADER]) + b"\x33" * 31),
            (0, bytes([pkg.ROLE_VOTER]) + _message(VOTE_PROGRAM_ID)),
            (1, bytes([pkg.ROLE_VOTER]) + _message(SYSTEM_PROGRAM_ID)),
            (0, bytes([pkg.ROLE_GOSSIP]) + b"crds value"),
            (1, bytes([pkg.ROLE_TLS]) + _TLS_CLIENT),
            (0, bytes([99]) + b"\x01" * 32),
            (1, b""),
            (0, bytes([pkg.ROLE_LEADER]) + b"\x44" * 20)]
    runs = []
    for tile in (ptiles.TILES["sign"](), jtiles.TILES["sign"]()):
        ctx = _Ctx({"key_path": kpath})
        tile.init(ctx)
        for iidx, payload in reqs:
            tile.on_frag(ctx, iidx, None, payload)
        runs.append((ctx.out, dict(ctx.metrics.d)))
    assert runs[0] == runs[1]
    out, m = runs[0]
    assert m == {"sign_cnt": 5, "refuse_cnt": 4}
    # each reply on the request's index, the role as its sig; a refusal
    # is an empty frag
    assert [(o, s) for _, s, o in out] == [
        (i, p[0] if p else 0) for i, p in reqs]
    assert out[0][0] == ped.sign(seed, b"\x33" * 32)
    assert [len(p) for p, _, _ in out] == [64, 0, 64, 0, 64, 64, 0, 0, 64]
