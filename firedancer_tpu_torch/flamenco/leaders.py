"""Stake-weighted leader schedule (ref: src/flamenco/leaders/fd_leaders.c):
epoch seed -> ChaCha20 rng -> weighted sampling over staked nodes, each
draw covering NUM_CONSECUTIVE_LEADER_SLOTS slots.

The port's own copy of firedancer_tpu/flamenco/leaders.py.
"""

import struct

from ..ballet.chacha20 import ChaCha20Rng
from ..ballet.wsample import WSample

NUM_CONSECUTIVE_LEADER_SLOTS = 4


def leader_schedule(epoch: int, stakes: dict[bytes, int],
                    slots_in_epoch: int) -> list[bytes]:
    """Returns the leader pubkey for each slot of the epoch.

    stakes: node pubkey -> active stake (zero-stake nodes excluded).
    Deterministic across every validator: nodes sort by (stake desc, pubkey
    desc) before sampling, the rng seeds from the epoch (fd_leaders.c
    ordering contract)."""
    staked = sorted(
        ((pk, st) for pk, st in stakes.items() if st > 0),
        key=lambda kv: (kv[1], kv[0]), reverse=True)
    if not staked:
        raise ValueError("no staked nodes")
    rng = ChaCha20Rng(struct.pack("<Q", epoch) + bytes(24))
    ws = WSample([st for _, st in staked])
    n_draws = (slots_in_epoch + NUM_CONSECUTIVE_LEADER_SLOTS - 1) \
        // NUM_CONSECUTIVE_LEADER_SLOTS
    sched = []
    for _ in range(n_draws):
        idx = ws.sample(rng)
        sched += [staked[idx][0]] * NUM_CONSECUTIVE_LEADER_SLOTS
    return sched[:slots_in_epoch]
