"""Child-process bodies for the port's multi-process ring tests.

Spawned children import this module, not the test files: it imports only
the port's rings (no JAX, no torch), so each child starts in well under a
second."""

import hashlib
import time

from firedancer_tpu_torch.tango.ring import Dcache, FSeq, MCache, Workspace

N_FRAGS = 5000
DEPTH = 64
RACE_DEPTH = 64
RACE_MTU = 512


def _layout(name):
    """Each process rebuilds the identical layout deterministically."""
    ws = Workspace(name, 1 << 20, create=False)
    mc = MCache.join(ws, ws.alloc(MCache.footprint(DEPTH)))
    fseqs = [FSeq.join(ws, ws.alloc(64)) for _ in range(2)]
    return ws, mc, fseqs


def producer(name):
    ws, mc, fseqs = _layout(name)
    sent = 0
    deadline = time.monotonic() + 60
    while sent < N_FRAGS and time.monotonic() < deadline:
        # reliable-consumer credit check (fd_mux.c:233-310 credit logic)
        lo = min(f.query() for f in fseqs)
        if sent - lo >= DEPTH - 1:
            continue
        mc.publish(sig=sent * 3 + 1)
        sent += 1
    mc = fseqs = None
    ws.close()


def consumer(name, idx, q):
    ws, mc, fseqs = _layout(name)
    fs = fseqs[idx]
    seq = acc = 0
    deadline = time.monotonic() + 60
    while seq < N_FRAGS and time.monotonic() < deadline:
        metas, rc = mc.consume_burst(seq, 32)
        for m in metas:
            acc += int(m["sig"])
        seq += len(metas)
        if rc == 1:
            q.put((idx, "overrun"))
            return
        fs.update(seq)
    q.put((idx, acc))
    mc = fseqs = fs = None
    ws.close()


def payload(seq: int) -> bytes:
    """Deterministic self-checking payload: body derived from seq."""
    body = hashlib.sha256(seq.to_bytes(8, "little")).digest() * 8
    return body[: 16 + (seq % (RACE_MTU - 48))]


def race_producer(name, mc_off, dc_off, fseq_off, n, err_q):
    try:
        ws = Workspace(name, 1 << 22)
        mc = MCache.join(ws, mc_off)
        dc = Dcache.join(ws, dc_off)
        fs = FSeq.join(ws, fseq_off)
        cur = dc.chunk0
        deadline = time.monotonic() + 120
        for i in range(n):
            # reliable flow control: don't lap the consumer
            while i - fs.query() >= RACE_DEPTH - 2:
                if time.monotonic() > deadline:
                    err_q.put("producer: stalled")
                    return
                time.sleep(0)
            data = payload(i)
            nxt = dc.write(cur, data)
            mc.publish(sig=i, chunk=cur, sz=len(data))
            cur = nxt
    except Exception as e:  # reported to the test through the queue
        err_q.put(f"producer: {e!r}")


def race_consumer(name, mc_off, dc_off, fseq_off, n, err_q):
    try:
        ws = Workspace(name, 1 << 22)
        mc = MCache.join(ws, mc_off)
        dc = Dcache.join(ws, dc_off)
        fs = FSeq.join(ws, fseq_off)
        base = mc.seq0()
        seq = base
        deadline = time.monotonic() + 120
        while seq < base + n:
            if time.monotonic() > deadline:
                err_q.put("consumer: stalled")
                return
            rc, m = mc.query(seq)
            if rc == -1:
                time.sleep(0)
                continue
            if rc == 1:
                err_q.put(f"consumer: reliable overrun at {seq}")
                return
            data = dc.read(int(m["chunk"]), int(m["sz"]))
            if data != payload(int(m["sig"])):
                err_q.put(f"consumer: torn frag at {seq}")
                return
            if int(m["sig"]) != seq - base:
                err_q.put(f"consumer: sig {m['sig']} != {seq - base}")
                return
            seq += 1
            fs.update(seq - base)
    except Exception as e:  # reported to the test through the queue
        err_q.put(f"consumer: {e!r}")


def unreliable_reader(name, mc_off, dc_off, n, err_q, done_q):
    """Overrun-tolerant consumer: must DETECT every overrun, never read a
    torn frag undetected."""
    try:
        ws = Workspace(name, 1 << 22)
        mc = MCache.join(ws, mc_off)
        dc = Dcache.join(ws, dc_off)
        seq = mc.seq0()
        end = seq + n
        seen = overruns = 0
        deadline = time.monotonic() + 120
        while seq < end and time.monotonic() < deadline:
            rc, m = mc.query(seq)
            if rc == -1:
                if mc.seq_query() >= end:
                    break
                time.sleep(0)
                continue
            if rc == 1:
                overruns += 1
                seq = max(seq + 1, mc.seq_query() - RACE_DEPTH // 2)
                continue
            data = bytes(dc.read(int(m["chunk"]), int(m["sz"])))
            rc2, m2 = mc.query(seq)
            still_valid = rc2 == 0 and int(m2["sig"]) == int(m["sig"])
            if still_valid and data != payload(int(m["sig"])):
                err_q.put(f"reader: undetected tear at {seq}")
                return
            seen += 1
            seq += 1
        done_q.put((seen, overruns))
    except Exception as e:  # reported to the test through the queue
        err_q.put(f"reader: {e!r}")
