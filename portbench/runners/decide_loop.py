"""Mixes of kind ``decide_loop``: a job's launch thread, one caller in a
closed loop.  Each step is ``CollectiveDispatcher.decide(coll, size,
n_ranks, axis_name=axis)`` and then ``profiler_feed`` of that
collective's latency, as ``chip_smoke.py``'s phase 5 drives the §5.3
loop.

Before the window the warm-up runs the mix's warm-up steps, on keys
outside the mix, so every attached program's kernel has run once and
every bridge path has been taken; the mix's own keys start cold, as they
do in a job.  The window runs whole chunks of steps until ``--seconds``
have passed; its length is the host clock from its first step to the end
of its last.

``correct``: every decision the window returned, and every entry of every
map after it, against the plain reference (``reference/policies.py``)
replaying the warm-up and the window's steps with the same latencies.
Both are exact comparisons: the limit is 0 mismatches.
"""

from __future__ import annotations

import sys
import time
from array import array
from typing import Dict, List, Optional

from .. import deploy
from ..harness import Compared, Outcome
from ..reference import policies as ref
from ..trace import Tracer, breakdown
from ..traffic import DecideStream, warmup_steps
from .common import decision_fields, device_record, read_peak

CHUNK = 256          # steps between looks at the clock


def run(cell, args) -> Outcome:
    conf, mix = cell.config, cell.mix
    n_ranks = int(conf["n_ranks"])
    rt, disp = deploy.build(conf, args.tier)
    for coll, size, axis, lat in warmup_steps(mix):
        d = disp.decide(coll, size, n_ranks, axis_name=axis)
        disp.profiler_feed(d.comm_id, lat, coll=d.coll,
                           msg_size=d.size_bytes, channels=d.channels,
                           algo=d.algo)
    if args.device == "cuda":
        import torch
        torch.cuda.synchronize()
    stream = DecideStream(mix, args.seed)
    max_blocks = (args.sizes or {}).get("max_blocks")
    calls0 = deploy.bridge_calls(rt)
    tuner_link = rt.chain("tuner")[0].link_id

    with Tracer(args.trace, args.device, float(mix["trace_s"])) as tr:
        t0 = time.perf_counter()
        win = window(disp, stream, n_ranks, t0 + args.seconds, tr,
                     max_blocks)
        t1 = time.perf_counter()
    peak = read_peak(args.device)
    n = len(win["decisions"])
    window_s = t1 - t0
    calls1 = deploy.bridge_calls(rt)
    summary = tr.summary()
    print("decisions/s by tenth of the window: " + " ".join(
        f"{r:.0f}" for r in tenths(win["marks"], t0)), file=sys.stderr)
    obs = {"decisions": n, "window_s": window_s,
           "decide_ns": win["decide_ns"], "feed_s": win["feed_ns"] / 1e9,
           "bridge_calls": sum(calls1[k] - calls0[k] for k in calls1),
           "tuner_chain_runs": calls1[tuner_link] - calls0[tuner_link],
           "trace": summary}
    compared = compare(conf, mix, args.seed, win["decisions"],
                       deploy.map_snapshots(rt))
    return Outcome(
        attempted=n, failed=0,
        end_to_end={"decisions_per_s": n / window_s,
                    "setup_s": t0 - args.t_start},
        obs=obs, compared=compared,
        device=device_record(args.device, 1, peak, summary),
        breakdown=breakdown(summary) if summary else None)


def tenths(marks, t0: float) -> List[float]:
    """The decision rate in each tenth of the window (a view of how steady
    the host was during the run)."""
    if not marks:
        return []
    end = marks[-1][0]
    out, prev_t, prev_n, k = [], t0, 0, 1
    for t, n in marks:
        if t >= t0 + (end - t0) * k / 10 or (t, n) == marks[-1]:
            out.append((n - prev_n) / max(t - prev_t, 1e-9))
            prev_t, prev_n, k = t, n, k + 1
    return out


def window(disp, stream: DecideStream, n_ranks: int, deadline: float, tr,
           max_blocks: Optional[int]) -> dict:
    """Decide and feed until ``deadline``; every decision kept, each
    decide() timed on the host clock."""
    decide, feed = disp.decide, disp.profiler_feed
    ns = time.perf_counter_ns
    clock = time.perf_counter
    axes = stream.axes
    decisions: List[object] = []
    keep = decisions.append
    decide_ns = array("q")
    took = decide_ns.append
    feed_ns = 0
    marks = []                  # (host clock, decisions) at each chunk's end
    b = 0
    while max_blocks is None or b < max_blocks:
        colls, sizes, ax, lats = (x.tolist() for x in stream.block(b))
        b += 1
        for j0 in range(0, len(colls), CHUNK):
            for j in range(j0, min(j0 + CHUNK, len(colls))):
                if tr.on:
                    with tr.span("decide"):
                        ta = ns()
                        d = decide(colls[j], sizes[j], n_ranks,
                                   axis_name=axes[ax[j]])
                        tb = ns()
                    with tr.span("feed"):
                        feed(d.comm_id, lats[j], coll=d.coll,
                             msg_size=d.size_bytes, channels=d.channels,
                             algo=d.algo)
                else:
                    ta = ns()
                    d = decide(colls[j], sizes[j], n_ranks,
                               axis_name=axes[ax[j]])
                    tb = ns()
                    feed(d.comm_id, lats[j], coll=d.coll,
                         msg_size=d.size_bytes, channels=d.channels,
                         algo=d.algo)
                feed_ns += ns() - tb
                took(tb - ta)
                keep(d)
            now = clock()
            marks.append((now, len(decisions)))
            if now >= deadline:
                return {"decisions": decisions, "decide_ns": decide_ns,
                        "feed_ns": feed_ns, "marks": marks}
            tr.tick()
    return {"decisions": decisions, "decide_ns": decide_ns,
            "feed_ns": feed_ns, "marks": marks}


def replay(conf: dict, mix: dict, seed: int, n: int,
           control: Optional[str] = None):
    """The reference's decisions for the window's first ``n`` steps, a
    block at a time (after the warm-up), and then its maps.  ``control``
    names a control (``reference/policies.py``) to replay in its place."""
    dep = ref.Deployment(conf)
    decide = ref.cached_by_size(dep.decide) \
        if control == "cache_key_size_only" else dep.decide
    n_ranks = int(conf["n_ranks"])
    for coll, size, axis, lat in warmup_steps(mix):
        dep.feed(decide(coll, size, n_ranks, axis), lat)
    stream = DecideStream(mix, seed)
    memo: Dict[tuple, tuple] = {}       # the pure chains' decisions by key
    done, b = 0, 0
    while done < n:
        colls, sizes, ax, lats = (x.tolist() for x in stream.block(b))
        b += 1
        out = []
        for c, s, a, t in zip(colls[:n - done], sizes, ax, lats):
            d = memo.get((c, s, a)) if dep.pure else None
            if d is None:
                d = decide(c, s, n_ranks, stream.axes[a])
                if dep.pure:
                    memo[(c, s, a)] = d
            dep.feed(d, t)
            out.append(d)
        done += len(out)
        yield out
    yield dep.snapshots()


def control_run(conf: dict, mix: dict, seed: int, n: int):
    """The configuration's control put in the program's place: its
    decisions, as the port's ``Decision`` fields, and its maps."""
    decisions: list = []
    for part in replay(conf, mix, seed, n, conf["control"]):
        if isinstance(part, dict):
            return decisions, part
        decisions += [ref.DecisionFields(*d) for d in part]


def compare(conf: dict, mix: dict, seed: int, decisions: list,
            snapshots: dict) -> List[Compared]:
    """Mismatched decisions and mismatched map entries, each against 0."""
    seen: Dict[int, tuple] = {}
    bad, i = 0, 0
    for want in replay(conf, mix, seed, len(decisions)):
        if isinstance(want, dict):
            break
        for w in want:
            d = decisions[i]
            got = seen.get(id(d))
            if got is None:
                got = seen[id(d)] = decision_fields(d)
            bad += got != w
            i += 1
    return [Compared("decision_mismatches", bad, 0),
            Compared("map_mismatches",
                     ref.mismatched_entries(snapshots, want), 0)]
