"""Per-link bottleneck attribution (the port's own copy of
firedancer_tpu/disco/attrib.py; ref: the reference monitor's
fctl/fseq diag rendering, src/app/fdctl/monitor/monitor.c:49-160 — which
link is backpressured, which consumer is slow, and one verdict line).

Pure reader over a joined topology: consumer-side state comes from each
(tile, in-link) fseq (seq + slow/ovrn diag, charged by the producer's
credit-stall loop in disco/mux.py), producer-side state from the mux's
out{j}_* housekeeping gauges (ring occupancy high-watermark, credit
low-watermark, publish rates).  Three consumers:

  * `fdtpuctl top`      — live terminal view (render_top)
  * /metrics            — producer->consumer labeled families
                          (link_families, via prometheus_render's extra=)
  * flight recorder     — link state at time of death (link_sample +
                          snapshot_verdict in the postmortem bundle)
"""

import time

from ..tango.ring import FSeq

# verdict thresholds: a consumer charged slow faster than this is THE
# bottleneck; else a ring whose occupancy high-watermark crossed this
# fraction of depth is close to stalling its producer
SLOW_RATE_HZ = 0.5
OCC_FRAC = 0.75

_REGIMES = ("busy_ns", "backp_ns", "house_ns", "idle_ns")

# leader-lane counters surfaced in `fdtpuctl top` (sharded pack steering,
# merge-point budget pressure, PoH speculation depth/hit rate)
_LEADER_KEYS = ("shard_steer_cnt", "pending",
                "merge_budget_defer_cnt", "merge_stall_cnt", "merge_q",
                "spec_hit_cnt", "spec_miss_cnt", "splice_dispatch_cnt",
                "spec_depth")


def producers_of(spec) -> dict[str, str]:
    """link name -> producing tile name."""
    out = {}
    for t in spec.tiles:
        for ln in t.out_links:
            out[ln] = t.name
    return out


def link_sample(jt) -> dict:
    """One attribution snapshot: per (link, consumer) the fseq-side
    state, per tile the regime counters + per-out-link gauges."""
    spec = jt.spec
    prod_of = producers_of(spec)
    s = {"t": time.monotonic_ns(), "links": {}, "tiles": {}}
    for t in spec.tiles:
        for il in t.in_links:
            fs = jt.fseq[(t.name, il.link)]
            jl = jt.links[il.link]
            s["links"][(il.link, t.name)] = {
                "producer": prod_of.get(il.link, "?"),
                "seq": fs.query(),
                "prod": jl.mcache.seq_query(),
                "depth": jl.spec.depth,
                "slow": fs.diag(FSeq.DIAG_SLOW_CNT),
                "ovrnp": fs.diag(FSeq.DIAG_OVRNP_CNT),
                "pub_cnt": fs.diag(FSeq.DIAG_PUB_CNT),
                "pub_sz": fs.diag(FSeq.DIAG_PUB_SZ),
            }
        m = jt.metrics[t.name].snapshot()
        tv = {k: m.get(k, 0) for k in
              _REGIMES + ("backp_cnt", "loop_cnt", "housekeep_cnt")}
        # leader-lane counters (sharded pack + PoH speculation), shown in
        # the `top` LEADER section when the topology runs those tiles
        for k in _LEADER_KEYS:
            if k in m:
                tv.setdefault("kv", {})[k] = m[k]
        tv["out"] = {}
        for oi, ln in enumerate(t.out_links[:4]):
            tv["out"][ln] = {
                "lag": m.get(f"out{oi}_lag", 0),
                "occ_hwm": m.get(f"out{oi}_occ_hwm", 0),
                "cr_lwm": m.get(f"out{oi}_cr_lwm", 0),
                "frag_rate": m.get(f"out{oi}_frag_rate", 0),
                "byte_rate": m.get(f"out{oi}_byte_rate", 0),
            }
        s["tiles"][t.name] = tv
    return s


def link_families(jt):
    """(name, kind, help, labels, value) samples for prometheus_render's
    `extra` hook: the per-link families, producer->consumer labeled."""
    s = link_sample(jt)
    out = []
    for (link, consumer), lv in s["links"].items():
        lab = {"link": link, "producer": lv["producer"],
               "consumer": consumer}
        out += [
            ("fdtpu_link_lag", "gauge",
             "frags the consumer trails the producer by", lab,
             max(lv["prod"] - lv["seq"], 0)),
            ("fdtpu_link_slow_cnt", "counter",
             "producer credit stalls attributed to this consumer", lab,
             lv["slow"]),
            ("fdtpu_link_ovrnp_cnt", "counter",
             "frags lost to producer overrun on this link", lab,
             lv["ovrnp"]),
            ("fdtpu_link_frag_cnt", "counter",
             "frags this consumer processed off the link", lab,
             lv["pub_cnt"]),
            ("fdtpu_link_sz", "counter",
             "payload bytes this consumer processed off the link", lab,
             lv["pub_sz"]),
        ]
    for tile, tv in s["tiles"].items():
        for link, ov in tv["out"].items():
            lab = {"link": link, "producer": tile}
            out += [
                ("fdtpu_link_occ_hwm", "gauge",
                 "ring occupancy high-watermark over the last window",
                 lab, ov["occ_hwm"]),
                ("fdtpu_link_cr_lwm", "gauge",
                 "producer credit low-watermark over the last window",
                 lab, ov["cr_lwm"]),
                ("fdtpu_link_frag_rate", "gauge",
                 "frags/s published over the last window", lab,
                 ov["frag_rate"]),
                ("fdtpu_link_byte_rate", "gauge",
                 "bytes/s published over the last window", lab,
                 ov["byte_rate"]),
            ]
    return out


def bottleneck(prev: dict, cur: dict) -> tuple[str, str]:
    """One-line verdict from two samples: ("<link>", "<reason>") — the
    link whose consumer is charging slow diag fastest, else the ring
    closest to full past the occupancy threshold, else the busiest tile
    (cpu-bound, no link pressure), else none."""
    dt = max((cur["t"] - prev["t"]) / 1e9, 1e-9)
    best = None  # (score, link_label, reason)
    for key, lv in cur["links"].items():
        link, consumer = key
        pv = prev["links"].get(key, lv)
        slow_rate = (lv["slow"] - pv["slow"]) / dt
        lag = max(lv["prod"] - lv["seq"], 0)
        occ = lag / max(lv["depth"], 1)
        label = f"{lv['producer']}->{consumer} ({link})"
        if slow_rate > SLOW_RATE_HZ:
            cand = (2e9 + slow_rate, label,
                    f"slow consumer {consumer} "
                    f"({slow_rate:.1f} stalls/s, lag {lag}/{lv['depth']})")
        elif occ >= OCC_FRAC:
            cand = (1e9 + occ, label,
                    f"ring {occ:.0%} full (lag {lag}/{lv['depth']})")
        else:
            continue
        if best is None or cand[0] > best[0]:
            best = cand
    if best is not None:
        return best[1], best[2]
    # no link pressure: name the busiest tile so "what would I scale
    # next" still has an answer
    busiest = None
    for tile, tv in cur["tiles"].items():
        pv = prev["tiles"].get(tile, tv)
        busy = tv["busy_ns"] - pv["busy_ns"]
        total = sum(tv[r] - pv[r] for r in _REGIMES)
        if total <= 0:
            continue
        frac = busy / total
        if busiest is None or frac > busiest[0]:
            busiest = (frac, tile)
    if busiest is not None and busiest[0] > 0.5:
        return "none", (f"no link pressure; busiest tile "
                        f"{busiest[1]} ({busiest[0]:.0%} busy)")
    return "none", "no backpressure observed"


def snapshot_verdict(sample: dict) -> tuple[str, str]:
    """bottleneck() without a prior sample (postmortem bundles): grades
    cumulative slow counts + instantaneous occupancy."""
    best = None
    for key, lv in sample["links"].items():
        link, consumer = key
        lag = max(lv["prod"] - lv["seq"], 0)
        occ = lag / max(lv["depth"], 1)
        label = f"{lv['producer']}->{consumer} ({link})"
        if lv["slow"] > 0:
            cand = (2e9 + lv["slow"], label,
                    f"slow consumer {consumer} ({lv['slow']} stalls "
                    f"total, lag {lag}/{lv['depth']})")
        elif occ >= OCC_FRAC:
            cand = (1e9 + occ, label,
                    f"ring {occ:.0%} full (lag {lag}/{lv['depth']})")
        else:
            continue
        if best is None or cand[0] > best[0]:
            best = cand
    if best is not None:
        return best[1], best[2]
    return "none", "no backpressure observed"


def render_top(spec, prev: dict, cur: dict) -> list[str]:
    """The `fdtpuctl top` frame: per-tile regime split, per-link lag and
    stall attribution, one bottleneck verdict line."""
    dt = max((cur["t"] - prev["t"]) / 1e9, 1e-9)
    lines = [f"fdtpu top — {spec.app}  (interval {dt:.2f}s, "
             "ctrl-c to exit)", ""]
    lines.append(f"{'TILE':<14}{'busy%':>7}{'backp%':>7}{'house%':>7}"
                 f"{'idle%':>7}{'backp/s':>9}")
    for tile, tv in cur["tiles"].items():
        pv = prev["tiles"].get(tile, tv)
        d = {r: tv[r] - pv[r] for r in _REGIMES}
        total = sum(d.values())

        def _pct(r):
            return f"{100 * d[r] / total:.0f}" if total > 0 else "-"

        backp_rate = (tv["backp_cnt"] - pv["backp_cnt"]) / dt
        lines.append(f"{tile:<14}{_pct('busy_ns'):>7}{_pct('backp_ns'):>7}"
                     f"{_pct('house_ns'):>7}{_pct('idle_ns'):>7}"
                     f"{backp_rate:>9,.0f}")
    lines.append("")
    lines.append(f"{'LINK':<34}{'rate/s':>10}{'lag':>8}{'occ%':>6}"
                 f"{'slow/s':>8}{'ovrn/s':>8}")
    for key, lv in cur["links"].items():
        link, consumer = key
        pv = prev["links"].get(key, lv)
        lag = max(lv["prod"] - lv["seq"], 0)
        occ = 100 * lag // max(lv["depth"], 1)
        lines.append(
            f"{lv['producer'] + '->' + consumer + ' (' + link + ')':<34}"
            f"{(lv['seq'] - pv['seq']) / dt:>10,.0f}"
            f"{lag:>8,}{occ:>6}"
            f"{(lv['slow'] - pv['slow']) / dt:>8,.1f}"
            f"{(lv['ovrnp'] - pv['ovrnp']) / dt:>8,.1f}")
    rows = [(t, tv["kv"]) for t, tv in cur["tiles"].items()
            if tv.get("kv")]
    if rows:
        lines.append("")
        lines.append("LEADER")
        for tile, kv in rows:
            pkv = prev["tiles"].get(tile, {}).get("kv", kv)
            parts = []
            for k, v in kv.items():
                if k.endswith("_cnt"):
                    parts.append(
                        f"{k[:-4]}/s {(v - pkv.get(k, v)) / dt:,.0f}")
                else:
                    parts.append(f"{k} {v:,}")
            lines.append(f"  {tile:<14}" + "  ".join(parts))
    lines.append("")
    link, reason = bottleneck(prev, cur)
    lines.append(f"bottleneck: {link} ({reason})")
    return lines
