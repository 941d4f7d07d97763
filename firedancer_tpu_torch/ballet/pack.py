"""Block-packing scheduler: fee-prioritized txn selection with account-
conflict-free microblock emission (ref: src/ballet/pack/ fd_pack.c,
fd_pack_cost.h, fd_pack_bitset.h); the port's own copy of
firedancer_tpu/ballet/pack.py.

Pack holds verified transactions in a fee-priority order and emits
microblocks such that no two concurrently-executing microblocks touch the
same account in a conflicting way, inside the consensus-critical block
limits (fd_pack.h:17-52).  Host-side by design: scheduling is branchy,
small-N work.  Every account hashes to a 64-bit key (acct_key) that sets
two bits of a 256-bit bloom bitset, so the conflict check is a few word
ANDs; a false positive can only defer a txn, never admit a conflicting
pair.

The hot loop has two bodies that emit the same microblock stream byte for
byte: the C scheduler (native/packsched.cpp, in the port's host library)
and the Python one.  native=None or True selects the C scheduler and
raises when the library does not build (the JAX package falls back to
Python silently at auto); native=False selects the Python scheduler.
"""

import ctypes
import struct
from dataclasses import dataclass
import heapq
from typing import Optional

from . import txn as txn_lib
from .base58 import decode as b58decode

# ---- consensus-critical limits (fd_pack.h:19-23) --------------------------
MAX_COST_PER_BLOCK = 48_000_000
MAX_VOTE_COST_PER_BLOCK = 36_000_000
MAX_WRITE_COST_PER_ACCT = 12_000_000
FEE_PER_SIGNATURE = 5_000  # lamports
MAX_DATA_PER_BLOCK = ((32 * 1024 - 17) // 31) * 25_871 + 48

MAX_BANK_TILES = 62  # FD_PACK_MAX_BANK_TILES

# ---- cost model constants (fd_pack_cost.h:74-76) --------------------------
COST_PER_SIGNATURE = 720
COST_PER_WRITABLE_ACCT = 300
INV_COST_PER_INSTR_DATA_BYTE = 4

# built-in program execution costs per instruction (fd_pack_cost.h:55-66,
# mirroring solana block_cost_limits.rs)
_BUILTIN_COSTS = {
    "Stake11111111111111111111111111111111111111": 750,
    "Config1111111111111111111111111111111111111": 450,
    "Vote111111111111111111111111111111111111111": 2_100,
    "11111111111111111111111111111111": 150,
    "ComputeBudget111111111111111111111111111111": 150,
    "AddressLookupTab1e1111111111111111111111111": 750,
    "BPFLoaderUpgradeab1e11111111111111111111111": 2_370,
    "BPFLoader1111111111111111111111111111111111": 1_140,
    "BPFLoader2111111111111111111111111111111111": 570,
    "LoaderV411111111111111111111111111111111111": 2_000,
    "KeccakSecp256k11111111111111111111111111111": 720,
    "Ed25519SigVerify111111111111111111111111111": 720,
}
BUILTIN_COSTS = {b58decode(k, 32): v for k, v in _BUILTIN_COSTS.items()}

VOTE_PROG_ID = b58decode("Vote111111111111111111111111111111111111111", 32)
COMPUTE_BUDGET_PROG_ID = b58decode(
    "ComputeBudget111111111111111111111111111111", 32
)

# non-builtin (BPF) instruction default CU allotment, overridable by a
# SetComputeUnitLimit compute-budget instruction
DEFAULT_INSTR_COMPUTE_UNITS = 200_000
MAX_COMPUTE_UNIT_LIMIT = 1_400_000

_M64 = (1 << 64) - 1


# ---- account keys + bloom bitsets (fd_pack_bitset.h analogue) -------------
def acct_key(addr: bytes) -> int:
    """64-bit account key: fold the four u64 limbs of the 32-byte address
    with distinct odd multipliers (a plain xor-fold cancels on repeated
    limb patterns), then the splitmix64 finalizer.  Implemented
    identically in native/packsched.cpp (fd_pack_acct_key) — the shard
    steering, budget table, and bitset bits all derive from this one
    function, so native and Python schedules stay bit-identical."""
    x = ((int.from_bytes(addr[0:8], "little") * 0x9E3779B97F4A7C15)
         ^ (int.from_bytes(addr[8:16], "little") * 0xC2B2AE3D27D4EB4F)
         ^ (int.from_bytes(addr[16:24], "little") * 0x165667B19E3779F9)
         ^ (int.from_bytes(addr[24:32], "little") * 0x27D4EB2F165667C5)) \
        & _M64
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


# ---- native scheduler (packsched.cpp) ------------------------------------
def _resolve_native(native):
    """native: None or True = the C scheduler (a library that does not
    build raises), False = the Python scheduler."""
    if native is False:
        return None
    from .. import native as native_mod
    return native_mod.lib()


# native insert arg blob: acct_addr_off, n_acct, sig_cnt, ro_signed,
# ro_unsigned, is_vote, payload_len, cost, prio, seq (packsched.cpp
# fd_pack_insert reads the same layout)
_INS_ARGS = struct.Struct("<IIIIIIIQQQ")


@dataclass(slots=True)
class TxnCost:
    total: int
    is_simple_vote: bool
    cu_price_micro_lamports: int  # from SetComputeUnitPrice
    requested_cu: Optional[int]


def compute_cost(parsed: txn_lib.Txn, payload: bytes, accts=None) -> TxnCost:
    """The consensus cost model: signatures + write locks + instr data +
    per-instruction execution costs (fd_pack_cost.h compute_cost).

    One pass: program ids are fetched as direct payload slices (only the
    1-2 instruction programs, never the full account list) and the
    compute-budget scan folds into the same instruction walk instead of
    re-deriving the accounts per helper.  Callers that already hold the
    account list may pass it via `accts`."""
    n_accts = parsed.acct_addr_cnt
    ao = parsed.acct_addr_off
    sig_cnt = parsed.signature_cnt
    cost = sig_cnt * COST_PER_SIGNATURE
    # writability is pure index arithmetic (fd_txn.h account ordering):
    # [0, sig_cnt - ro_signed) writable-signed, [sig_cnt, cnt - ro_unsigned)
    # writable-unsigned
    writable_cnt = (
        sig_cnt - parsed.readonly_signed_cnt
        + max(parsed.acct_addr_cnt - sig_cnt - parsed.readonly_unsigned_cnt, 0)
        + parsed.addr_table_adtl_writable_cnt
    )
    cost += writable_cnt * COST_PER_WRITABLE_ACCT

    data_bytes = 0
    cu_limit = None
    cu_price = 0
    exec_cost = 0
    bpf_instr_cnt = 0
    for ins in parsed.instrs:
        data_bytes += ins.data_sz
        pid = ins.program_id
        if pid < n_accts:
            if accts is not None:
                prog = accts[pid]
            else:
                prog = payload[ao + pid * 32 : ao + pid * 32 + 32]
        else:
            prog = None
        builtin = BUILTIN_COSTS.get(prog)
        if builtin is None:
            bpf_instr_cnt += 1
            continue
        exec_cost += builtin
        if prog == COMPUTE_BUDGET_PROG_ID:
            data = payload[ins.data_off : ins.data_off + ins.data_sz]
            if len(data) >= 5 and data[0] == 2:
                cu_limit = min(
                    int.from_bytes(data[1:5], "little"),
                    MAX_COMPUTE_UNIT_LIMIT)
            elif len(data) >= 9 and data[0] == 3:
                cu_price = int.from_bytes(data[1:9], "little")
    cost += data_bytes // INV_COST_PER_INSTR_DATA_BYTE
    if bpf_instr_cnt:
        exec_cost += (
            cu_limit
            if cu_limit is not None
            else min(
                bpf_instr_cnt * DEFAULT_INSTR_COMPUTE_UNITS, MAX_COMPUTE_UNIT_LIMIT
            )
        )

    is_simple_vote = False
    if sig_cnt == 1 and len(parsed.instrs) == 1:
        pid = parsed.instrs[0].program_id
        if pid < n_accts:
            pb = (accts[pid] if accts is not None
                  else payload[ao + pid * 32 : ao + pid * 32 + 32])
            is_simple_vote = pb == VOTE_PROG_ID
    return TxnCost(cost + exec_cost, is_simple_vote, cu_price, cu_limit)


def reward(parsed: txn_lib.Txn, cost: TxnCost) -> int:
    """Validator reward in lamports: base fee share + priority fee."""
    base = parsed.signature_cnt * FEE_PER_SIGNATURE
    cu = cost.requested_cu if cost.requested_cu is not None else cost.total
    priority = (cost.cu_price_micro_lamports * cu) // 1_000_000
    return base + priority


@dataclass(slots=True)
class _Held:
    payload: bytes
    parsed: txn_lib.Txn
    cost: TxnCost
    rew: int
    seq: int        # FIFO tiebreak
    wkeys: tuple    # unique writable account keys (Python path; () native)
    wmask: int      # 256-bit writable bloom bitset (Python path)
    rmask: int      # 256-bit readonly bloom bitset (Python path)


def writable_key_costs(h: _Held) -> dict:
    """Per-account write cost contributions of one held txn: unique
    writable account key -> cost.total.  Derived from the parsed payload
    (not the scheduler state) so it works on both the native and the
    Python path — the sharded merge wire rides on this."""
    parsed = h.parsed
    o = parsed.acct_addr_off
    payload = h.payload
    out = {}
    for i in range(parsed.acct_addr_cnt):
        if parsed.is_writable(i):
            k = acct_key(payload[o + i * 32:o + (i + 1) * 32])
            out[k] = h.cost.total
    return out


@dataclass
class Microblock:
    bank: int
    txns: list  # list[_Held]

    @property
    def payloads(self) -> list[bytes]:
        return [h.payload for h in self.txns]


class MergeBudget:
    """Global block budgets enforced at the shard-merge point.

    Each sharded leader_pack tile runs its own Pack with the FULL block
    budget (shard-local admission is only a pre-filter); the merge tile
    owns the consensus-critical global accounting and admits per-shard
    microblocks against it atomically (check everything, then commit).
    Keyed by the same u64 acct_key the scheduler uses, carried on the
    merge wire so the merge never re-parses txns.

    Convergence invariant the drain path relies on: any microblock a
    shard emits fits a FRESH budget (per-txn oversize is dropped at
    insert, and no two txns in one microblock write the same account),
    so resetting via end_block always unblocks a stalled head."""

    def __init__(self):
        self.block_cost = 0
        self.block_vote_cost = 0
        self.block_data = 0
        self.acct_write_cost: dict = {}

    def try_admit(self, cost: int, vote_cost: int, data: int,
                  items) -> bool:
        """items: iterable of (acct_key u64, write cost).  All-or-nothing:
        returns False without mutating anything if any budget would
        overflow."""
        if self.block_cost + cost > MAX_COST_PER_BLOCK:
            return False
        if vote_cost and (self.block_vote_cost + vote_cost
                          > MAX_VOTE_COST_PER_BLOCK):
            return False
        if self.block_data + data > MAX_DATA_PER_BLOCK:
            return False
        awc = self.acct_write_cost
        for k, c in items:
            if awc.get(k, 0) + c > MAX_WRITE_COST_PER_ACCT:
                return False
        self.block_cost += cost
        self.block_vote_cost += vote_cost
        self.block_data += data
        for k, c in items:
            awc[k] = awc.get(k, 0) + c
        return True

    def end_block(self):
        self.block_cost = 0
        self.block_vote_cost = 0
        self.block_data = 0
        self.acct_write_cost.clear()


class Pack:
    """The pack scheduler state machine.

    insert() verified txns; schedule() emits a conflict-free microblock for
    a free bank lane; done() releases a lane's account locks;
    end_block() resets block-level accounting for the next slot.

    native: None or True = the C scheduler (raises when the host library
    does not build), False = the Python scheduler.  Both emit
    bit-identical microblock streams.
    """

    def __init__(self, bank_tile_cnt: int, max_txn_per_microblock: int = 31,
                 max_pending: int = 0, native=None):
        if not (1 <= bank_tile_cnt <= MAX_BANK_TILES):
            raise ValueError("bad bank tile count")
        self.bank_cnt = bank_tile_cnt
        self.max_txn_per_microblock = max_txn_per_microblock
        # heap admission cap (0 = unbounded).  Simple votes bypass the cap
        # — the reference reserves a vote lane so consensus traffic is
        # never crowded out by a fee-paying flood (fd_pack extra txn
        # handling); a full heap sheds the lowest-value REGULAR txns.
        self.max_pending = int(max_pending)
        # hard pool bound (native slot arrays are fixed-capacity; the
        # Python path honors the same bound so the paths shed identically —
        # votes bypass max_pending but not the pool)
        self.pool_cap = (max(1024, 2 * self.max_pending)
                         if self.max_pending else 65536)
        self._seq = 0
        self._pending = 0
        self._busy = [False] * bank_tile_cnt
        # block accounting (mirrored on the native path per committed
        # microblock except acct_write_cost, which lives in the C table)
        self.block_cost = 0
        self.block_vote_cost = 0
        self.block_data = 0
        self.acct_write_cost: dict = {}
        self.metrics = {
            "inserted": 0,
            "vote_inserted": 0,
            "scheduled": 0,
            "microblocks": 0,
            "dropped_oversize": 0,
            "dropped_heap_full": 0,
            "delayed_conflict": 0,
        }

        self._L = _resolve_native(native)
        self._c = None
        if self._L is not None:
            self._c = self._L.fd_pack_new(bank_tile_cnt, self.pool_cap)
            if not self._c:
                raise MemoryError("fd_pack_new failed")
            self._slots: dict = {}  # native slot idx -> _Held
            self._out = (ctypes.c_longlong
                         * max(1, max_txn_per_microblock))()
        else:
            self._heap: list = []  # (-priority, seq, _Held)
            # incremental busy bitsets: per-bank write/read masks plus the
            # cached unions schedule() starts from (no
            # set().union(*inflight) per call)
            self._bank_w = [0] * bank_tile_cnt
            self._bank_r = [0] * bank_tile_cnt
            self._gw = 0    # union of in-flight writable masks
            self._grw = 0   # union of in-flight writable+readonly masks

    @property
    def native(self) -> bool:
        return self._c is not None

    def __del__(self):
        c, L = getattr(self, "_c", None), getattr(self, "_L", None)
        if c and L is not None:
            try:
                L.fd_pack_delete(c)
            except Exception:
                pass
            self._c = None

    # ------------------------------------------------------------- ingest
    def insert(self, payload: bytes, parsed: txn_lib.Txn) -> bool:
        cost = compute_cost(parsed, payload)
        if cost.total > MAX_COST_PER_BLOCK:
            self.metrics["dropped_oversize"] += 1
            return False
        if (
            self.max_pending
            and self._pending >= self.max_pending
            and not cost.is_simple_vote
        ):
            self.metrics["dropped_heap_full"] += 1
            return False
        if self._pending >= self.pool_cap:
            self.metrics["dropped_heap_full"] += 1
            return False
        rew = reward(parsed, cost)
        # priority = reward per cost unit, scaled to keep integer math;
        # saturated to u64 so native and Python order identically
        prio = (rew << 20) // max(cost.total, 1)
        if prio > _M64:
            prio = _M64
        if self._c is not None:
            idx = self._L.fd_pack_insert(
                self._c, payload,
                _INS_ARGS.pack(
                    parsed.acct_addr_off, parsed.acct_addr_cnt,
                    parsed.signature_cnt, parsed.readonly_signed_cnt,
                    parsed.readonly_unsigned_cnt, cost.is_simple_vote,
                    len(payload), cost.total, prio, self._seq))
            if idx < 0:
                self.metrics["dropped_heap_full"] += 1
                return False
            self._slots[idx] = _Held(payload, parsed, cost, rew, self._seq,
                                     (), 0, 0)
        else:
            wmask = rmask = 0
            wseen: dict = {}
            o = parsed.acct_addr_off
            for i in range(parsed.acct_addr_cnt):
                k = acct_key(payload[o + i * 32 : o + (i + 1) * 32])
                m = (1 << (k & 255)) | (1 << ((k >> 8) & 255))
                if parsed.is_writable(i):
                    wmask |= m
                    wseen[k] = None
                else:
                    rmask |= m
            h = _Held(payload, parsed, cost, rew, self._seq,
                      tuple(wseen), wmask, rmask)
            heapq.heappush(self._heap, (-prio, self._seq, h))
        self._seq += 1
        self._pending += 1
        self.metrics["inserted"] += 1
        if cost.is_simple_vote:
            self.metrics["vote_inserted"] += 1
        return True

    @property
    def pending(self) -> int:
        return self._pending

    def clear_pending(self) -> int:
        """Drop every held txn (drain-protocol shed); returns the count."""
        n = self._pending
        if self._c is not None:
            self._L.fd_pack_clear_pending(self._c)
            self._slots.clear()
        else:
            self._heap.clear()
        self._pending = 0
        return n

    # ---------------------------------------------------------- schedule
    def schedule(self, bank: int) -> Optional[Microblock]:
        """Emit a microblock for idle bank lane `bank` (None if nothing
        schedulable).  Locks the lane until done(bank)."""
        if self._busy[bank]:
            raise ValueError(f"bank {bank} still executing")
        if self._c is not None:
            chosen = self._schedule_native(bank)
        else:
            chosen = self._schedule_py(bank)
        if not chosen:
            return None
        self._busy[bank] = True
        self._pending -= len(chosen)
        for h in chosen:
            self.block_cost += h.cost.total
            if h.cost.is_simple_vote:
                self.block_vote_cost += h.cost.total
            self.block_data += len(h.payload)
        self.metrics["scheduled"] += len(chosen)
        self.metrics["microblocks"] += 1
        return Microblock(bank, chosen)

    def _schedule_native(self, bank: int):
        delayed = ctypes.c_longlong(0)
        n = self._L.fd_pack_schedule(
            self._c, bank, self.max_txn_per_microblock, self._out,
            ctypes.byref(delayed))
        self.metrics["delayed_conflict"] += delayed.value
        return [self._slots.pop(self._out[i]) for i in range(n)]

    def _schedule_py(self, bank: int):
        # start from the incrementally-maintained busy unions: my writes
        # vs their reads+writes, my reads vs their writes
        w_busy = self._gw
        rw_busy = self._grw
        chosen: list[_Held] = []
        skipped = []
        # per-class accumulators for the microblock being built: the block
        # caps must count txns already CHOSEN this call, not just committed
        # blocks, or one wide microblock sails past every limit
        mb_cost = 0
        mb_vote_cost = 0
        mb_data = 0
        heap = self._heap
        awc = self.acct_write_cost
        while heap and len(chosen) < self.max_txn_per_microblock:
            item = heapq.heappop(heap)
            h = item[2]
            c = h.cost.total
            if self.block_cost + mb_cost + c > MAX_COST_PER_BLOCK:
                skipped.append(item)
                break
            if h.cost.is_simple_vote and (
                self.block_vote_cost + mb_vote_cost + c
                > MAX_VOTE_COST_PER_BLOCK
            ):
                skipped.append(item)
                continue
            if self.block_data + mb_data + len(h.payload) \
                    > MAX_DATA_PER_BLOCK:
                skipped.append(item)
                continue
            if (h.wmask & rw_busy) or (h.rmask & w_busy):
                self.metrics["delayed_conflict"] += 1
                skipped.append(item)
                continue
            if any(awc.get(k, 0) + c > MAX_WRITE_COST_PER_ACCT
                   for k in h.wkeys):
                skipped.append(item)
                continue
            # accept.  Consensus requires txns within one entry/microblock
            # to be mutually non-conflicting (they may replay in parallel),
            # so chosen txns' accounts join the busy bitsets immediately.
            chosen.append(h)
            mb_cost += c
            if h.cost.is_simple_vote:
                mb_vote_cost += c
            mb_data += len(h.payload)
            w_busy |= h.wmask
            rw_busy |= h.wmask | h.rmask
        for item in skipped:
            heapq.heappush(heap, item)
        if not chosen:
            return chosen
        bw = self._bank_w[bank]
        br = self._bank_r[bank]
        for h in chosen:
            bw |= h.wmask
            br |= h.rmask
            for k in h.wkeys:
                awc[k] = awc.get(k, 0) + h.cost.total
        self._bank_w[bank] = bw
        self._bank_r[bank] = br
        self._gw |= bw
        self._grw |= bw | br
        return chosen

    def done(self, bank: int):
        """Bank lane finished executing its microblock; release locks."""
        if self._c is not None:
            self._L.fd_pack_done(self._c, bank)
        else:
            self._bank_w[bank] = 0
            self._bank_r[bank] = 0
            # shared bits can't be subtracted out of a bloom union: fold
            # the surviving banks' masks (bank_cnt <= 62 int ORs, still
            # O(banks) not O(inflight accounts))
            gw = 0
            grw = 0
            for w, r in zip(self._bank_w, self._bank_r):
                gw |= w
                grw |= w | r
            self._gw = gw
            self._grw = grw
        self._busy[bank] = False

    def end_block(self):
        """Slot boundary: reset block-level accounting (leftover pending
        txns carry to the next block, as the reference's pack does)."""
        if any(self._busy):
            raise ValueError("end_block with banks still executing")
        self.block_cost = 0
        self.block_vote_cost = 0
        self.block_data = 0
        self.acct_write_cost.clear()
        if self._c is not None:
            self._L.fd_pack_end_block(self._c)
