"""Stage-budget SLO engine (the port's own copy of
firedancer_tpu/disco/slo.py): fold fdtrace spans into the named stage
pipeline wire -> reasm -> ring-wait -> coalesce -> dispatch-queue ->
device -> harvest -> publish and grade each stage against its share of
the end-to-end latency target (2 ms p99 packet->verdict by default).

Every stage maps to a span source that already exists in the live trace
rings (disco/trace.py) — the engine is a pure reader:

    wire            quic_server KIND_STAGE spans (socket drain + QUIC rx)
    reasm           ingress-tile KIND_FRAG/BURST callback durations
    ring-wait       verify-tile KIND_FRAG/BURST hop_ns (producer tspub ->
                    consume: time spent queued in the tango ring)
    coalesce        KIND_COALESCE (first txn in bucket -> dispatch)
    dispatch-queue  KIND_DISPATCH (dispatch call + over-budget drain)
    device          KIND_DEVICE (dispatch -> verdict materialized)
    harvest         KIND_HARVEST (verdict -> passing txns rebuilt)
    publish         KIND_PUBLISH (txns -> downstream ring publish)

The budget split is a fixed fraction per stage of the e2e target (the
device leg dominates by design; the host stages exist to stay small).
Burn rate is measured from the terminal tiles' whole-chain age stamps
(frag-meta tsorig -> consume): the fraction of chain completions in the
window whose age exceeded the target, with a first-half/second-half
trend so a worsening burn is visible before the window saturates.
"""

import numpy as np

from ..utils.hist import Histf
from . import trace as trace_mod

DEFAULT_TARGET_MS = 2.0

STAGES = ["wire", "reasm", "ring-wait", "coalesce", "dispatch-queue",
          "device", "harvest", "publish"]

# fraction of the e2e target each stage may burn at p99 (sums to 1.0)
BUDGET_FRAC = {
    "wire": 0.05, "reasm": 0.05, "ring-wait": 0.10, "coalesce": 0.20,
    "dispatch-queue": 0.10, "device": 0.35, "harvest": 0.10,
    "publish": 0.05,
}

# tile kinds whose frag callbacks ARE the reassembly/parse stage
_INGRESS_KINDS = {"source", "net", "quic", "quic_server"}
# tile kinds that run the verify pipeline (ring-wait measured here)
_VERIFY_KINDS = {"verify"}
# tile kinds downstream of verify: their age_ns is the whole-chain
# latency the SLO grades (first match wins as the burn source)
_TERMINAL_KINDS = {"dedup", "sink", "pack", "bank", "store"}

_RX_KINDS = (trace_mod.KIND_FRAG, trace_mod.KIND_BURST)


def collect(jt, since: int = 0):
    """Snapshot every tile's trace ring -> (spans_by_tile, kind_of)."""
    spans, kind_of = {}, {}
    for tname, ring in jt.trace.items():
        _, recs = ring.snapshot(since)
        spans[tname] = recs
        kind_of[tname] = jt.tile_spec(tname).kind
    return spans, kind_of


def _rx_mask(recs):
    return (recs["kind"] == _RX_KINDS[0]) | (recs["kind"] == _RX_KINDS[1])


def stage_samples(spans_by_tile, kind_of) -> dict[str, np.ndarray]:
    """Per stage, the ns samples (one per span) feeding its p50/p99."""
    out = {s: [] for s in STAGES}
    for tile, recs in spans_by_tile.items():
        if not len(recs):
            continue
        kind = kind_of.get(tile, "")
        if kind in _INGRESS_KINDS:
            rx = recs[_rx_mask(recs)]
            if len(rx):
                out["reasm"].append(rx["dur"].astype(np.int64))
            st = recs[recs["kind"] == trace_mod.KIND_STAGE]
            if len(st):
                out["wire"].append(st["dur"].astype(np.int64))
        if kind in _VERIFY_KINDS:
            rx = recs[_rx_mask(recs)]
            hops = rx["hop_ns"][rx["hop_ns"] > 0]
            if len(hops):
                out["ring-wait"].append(hops.astype(np.int64))
        for stage, k in (("coalesce", trace_mod.KIND_COALESCE),
                         ("dispatch-queue", trace_mod.KIND_DISPATCH),
                         ("device", trace_mod.KIND_DEVICE),
                         ("harvest", trace_mod.KIND_HARVEST),
                         ("publish", trace_mod.KIND_PUBLISH)):
            sel = recs[recs["kind"] == k]
            if len(sel):
                out[stage].append(sel["dur"].astype(np.int64))
    return {s: (np.concatenate(v) if v else np.zeros(0, np.int64))
            for s, v in out.items()}


def _pctl(samples: np.ndarray, q: float) -> float:
    if not len(samples):
        return 0.0
    # vectorized Histf fill (healthz calls this per scrape): same edges,
    # same first-bucket-reaching-ceil(q*total) percentile
    h = Histf(100, 60e9)
    idx = np.searchsorted(h.edges, np.maximum(samples, 1))
    np.add.at(h.counts, idx, 1)
    return h.percentile(q)


def stage_stats(spans_by_tile, kind_of,
                target_ms: float = DEFAULT_TARGET_MS) -> list[dict]:
    """One row per stage: sample count, p50/p99 ns, budget ns, pass."""
    target_ns = target_ms * 1e6
    rows = []
    samples_all = stage_samples(spans_by_tile, kind_of)
    for stage in STAGES:
        s = samples_all[stage]
        budget = BUDGET_FRAC[stage] * target_ns
        p50 = _pctl(s, 0.50)
        p99 = _pctl(s, 0.99)
        rows.append({
            "stage": stage, "n": int(len(s)), "p50_ns": p50, "p99_ns": p99,
            "budget_ns": budget, "ok": (len(s) == 0) or (p99 <= budget),
        })
    return rows


def burn(spans_by_tile, kind_of,
         target_ms: float = DEFAULT_TARGET_MS) -> dict:
    """Window burn rate from whole-chain age stamps: fraction of chain
    completions whose age exceeded the e2e target, with a first/second
    half split (by span ts) for trend."""
    target_ns = target_ms * 1e6
    ages, ts = [], []
    # terminal tiles first; any tile with age stamps as the fallback so
    # a verify-terminated topology still grades (verify's own age = the
    # chain up to dispatch admission)
    for pick_terminal in (True, False):
        for tile, recs in spans_by_tile.items():
            is_term = kind_of.get(tile, "") in _TERMINAL_KINDS
            if pick_terminal != is_term or not len(recs):
                continue
            rx = recs[_rx_mask(recs)]
            rx = rx[rx["age_ns"] > 0]
            if len(rx):
                ages.append(rx["age_ns"].astype(np.int64))
                ts.append(rx["ts"].astype(np.int64))
        if ages:
            break
    if not ages:
        return {"n": 0, "rate": 0.0, "rate_first": 0.0,
                "rate_second": 0.0, "trend": "flat"}
    age = np.concatenate(ages)
    t = np.concatenate(ts)
    viol = age > target_ns
    mid = np.median(t)
    first, second = viol[t <= mid], viol[t > mid]
    rf = float(first.mean()) if len(first) else 0.0
    rs = float(second.mean()) if len(second) else 0.0
    trend = "up" if rs > rf + 0.01 else ("down" if rf > rs + 0.01
                                         else "flat")
    return {"n": int(len(age)), "rate": float(viol.mean()),
            "rate_first": rf, "rate_second": rs, "trend": trend}


def render_table(stats: list[dict], burn_info: dict,
                 target_ms: float = DEFAULT_TARGET_MS) -> str:
    """Terminal stage-budget table (`fdtpuctl slo`)."""
    lines = [f"stage budget vs {target_ms:g} ms p99 e2e target",
             f"{'STAGE':<16}{'SPANS':>7}{'p50':>10}{'p99':>10}"
             f"{'BUDGET':>10}  VERDICT"]

    def _ms(v):
        return f"{v / 1e6:.3f}ms" if v else "-"

    for r in stats:
        verdict = "-" if r["n"] == 0 else ("ok" if r["ok"] else "OVER")
        lines.append(
            f"{r['stage']:<16}{r['n']:>7}{_ms(r['p50_ns']):>10}"
            f"{_ms(r['p99_ns']):>10}{_ms(r['budget_ns']):>10}  {verdict}")
    b = burn_info
    lines.append(
        f"burn rate: {b['rate']:.1%} of {b['n']} chain completions over "
        f"target (first half {b['rate_first']:.1%}, second "
        f"{b['rate_second']:.1%}, trend {b['trend']})")
    return "\n".join(lines)


def healthz_field(jt, target_ms: float = DEFAULT_TARGET_MS) -> str:
    """One-line slo summary for /healthz: worst over-budget stage (or
    ok) + burn rate — degraded latency visible without a trace dump."""
    spans, kind_of = collect(jt)
    stats = stage_stats(spans, kind_of, target_ms)
    b = burn(spans, kind_of, target_ms)
    over = [r for r in stats if r["n"] and not r["ok"]]
    if over:
        worst = max(over, key=lambda r: r["p99_ns"] / max(r["budget_ns"], 1))
        state = (f"over:{worst['stage']} "
                 f"p99={worst['p99_ns'] / 1e6:.3f}ms")
    else:
        state = "ok"
    return f"slo {state} burn={b['rate']:.3f} n={b['n']}"
