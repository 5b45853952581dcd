"""Mixes of kind ``train``: the port's ``Trainer`` on one card, bf16
compute over float32 master weights and AdamW, activation checkpointing
on, deterministic algorithms off (as a job runs), with the
configuration's programs attached to the process-wide dispatcher: each
step's latency goes to the profiler chain (the trainer feeds it) and one
decision is made after each feed, for the mix's gradient bucket.

Set-up builds one ``Trainer``, fills its parameters with the weights made
from the seed (``weights.py``) and starts the one ``Trainer.run`` the cell
makes, as a job does, its data pipeline prefetching from the seed: the
mix's checked steps are that run's first steps, and the feed after the
last of them takes their readings; the window opens after the mix's
settling steps, once the prefetch queue has drained to its steady state,
so no second run, no cold prefetch and no queue filled during the warm-up
enters it.  The feed after the step that passes
``--seconds`` ends the run (``WindowClosed``), so the window holds whole
steps and ends when the last has synchronised and been fed.
``train_tokens_per_s`` is the window's tokens over its length.

``correct``: the checked steps against the plain reference
(``reference/qwen3.py``) on the same weights and batches, made again from
the seed after the window: each step's loss (the worst step), each
leaf's norm of the first gradient as the optimizer got it (its first
moment after step 1 over ``1 - b1``; the median leaf) and each leaf's
norm of the change after the checked steps (the worst moving leaf); and
every decision of the window and the set-up against the reference's
replay of the policy plane.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Callable, Dict, List

from .. import deploy, weights
from ..flops import model_flops_per_step
from ..harness import ROOT, Compared, Outcome
from ..reference import policies as ref_pol
from ..reference import qwen3 as ref_q
from ..trace import Tracer, breakdown
from ..traffic import COLLS, TokenCorpus
from .common import decision_fields, device_record, read_peak

PEAK_BF16_FLOPS = 989e12    # H100 SXM data sheet, dense bf16, at 700 W


def data_seed(seed: int) -> int:
    """The corpus seed (the port's pipeline takes one under 2**31)."""
    return int(seed) % (2**31 - 1)


def port_config(model: dict, sizes: dict):
    from repro_torch.configs import get_config
    cfg = get_config(model["port_config"]).with_overrides(
        **model["port_overrides"], **sizes.get("port_overrides", {}))
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
           cfg.d_ff, cfg.vocab, cfg.tie_embeddings, cfg.qk_norm,
           cfg.rope_theta)
    want = (model["num_hidden_layers"], model["hidden_size"],
            model["num_attention_heads"], model["num_key_value_heads"],
            model["head_dim"], model["intermediate_size"],
            model["vocab_size"], model["tie_word_embeddings"], True,
            float(model["rope_theta"]))
    if got != want:
        raise ValueError(f"the port's {model['port_config']} gives {got}, "
                         f"the model file {want}")
    return cfg


class WindowClosed(Exception):
    """Raised from the feed after the step that ends the window."""


class DecidingFeed:
    """Wraps the dispatcher's ``profiler_feed``, which the trainer calls
    after each step: each feed is recorded and followed by the step's
    decision, recorded too; then the hook set for that step runs, if any.
    Once ``deadline`` has passed it ends the trainer's run after that
    step, at ``closed_at``."""

    def __init__(self, disp, mix: dict, n_ranks: int):
        self.disp, self.feed = disp, disp.profiler_feed
        self.d = mix["decide"]
        self.n_ranks = n_ranks
        self.events: List[tuple] = []
        self.times: List[float] = []                    # host clock
        self.decisions: List[object] = []
        self.hooks: Dict[int, Callable[[], None]] = {}   # by step, from 1
        self.deadline = self.closed_at = float("inf")
        self.tracer = None
        disp.profiler_feed = self

    def __call__(self, comm_id, latency_ns, **kw):
        self.feed(comm_id, latency_ns, **kw)
        self.events.append((comm_id, latency_ns, kw))
        self.decisions.append(self.disp.decide(
            COLLS[self.d["coll"]], int(self.d["bytes"]), self.n_ranks,
            axis_name=self.d["axis"]))
        hook = self.hooks.pop(len(self.events), None)
        if hook is not None:
            hook()
        if self.tracer is not None:
            self.tracer.tick()
        now = time.perf_counter()
        self.times.append(now)
        if now >= self.deadline:
            self.closed_at = now
            raise WindowClosed


def run(cell, args) -> Outcome:
    import torch
    from repro_torch.data import DataConfig
    from repro_torch.models.layers import MeshAxes
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.train import (AdamWConfig, Trainer, TrainerConfig,
                                   TrainStepConfig)

    mix, conf = cell.mix, cell.config
    sizes = args.sizes or {}
    model = dict(cell.model, **sizes.get("model", {}))
    B, S = sizes.get("batch", mix["batch"]), sizes.get("seq", mix["seq"])
    cfg = port_config(model, sizes)
    rt, disp = deploy.build(conf, args.tier)
    feeds = DecidingFeed(disp, mix, int(conf["n_ranks"]))
    n_checked = int(mix["checked_steps"])
    n_setup = n_checked + int(sizes.get("settle_steps", mix["settle_steps"]))
    tcfg = TrainerConfig(
        steps=n_checked, log_every=10 ** 9, ckpt_every=0,
        ckpt_dir=str(ROOT / "build" / "portbench" / "ckpt"), seed=0,
        data=DataConfig(seq_len=S, global_batch=B,
                        seed=data_seed(args.seed)),
        step=TrainStepConfig(opt=AdamWConfig(**mix["opt"]),
                             total_steps=int(mix["total_steps"]),
                             warmup_steps=int(mix["warmup_steps"])))
    dev = args.device
    tr = Trainer(cfg, MeshAxes(dp=1, tp=1), None, tcfg, device=dev)
    weights.fill(tree_leaves(tr.params), model, args.seed, dev)
    trc = Tracer(args.trace, dev, float(mix["trace_s"]))
    opened: Dict[str, float] = {}

    with contextlib.ExitStack() as stack:
        prog = checked_steps(tr, feeds, model, args.seed, dev, n_checked,
                             mix)
        before = feeds.hooks.get(n_setup)

        def open_window():
            if before is not None:
                before()
            stack.enter_context(trc)
            feeds.tracer = trc
            opened["t0"] = time.perf_counter()
            feeds.deadline = opened["t0"] + args.seconds

        feeds.hooks[n_setup] = open_window
        try:
            tr.run(steps=n_setup + int(sizes.get("window_steps", 10 ** 9)))
        except WindowClosed:
            pass
        t0 = opened["t0"]
        t1 = min(feeds.closed_at, time.perf_counter())
    window_s = t1 - t0
    prog = losses(tr, prog, n_checked)
    peak = read_peak(dev)
    summary = trc.summary()
    steps = feeds.events[n_setup:]
    gaps = [b - a for a, b in zip([t0] + feeds.times[n_setup:],
                                  feeds.times[n_setup:])]
    print("seconds from feed to feed, set-up: " + " ".join(
        f"{b - a:.3f}" for a, b in zip(feeds.times, feeds.times[1:n_setup]))
        + "; window: " + " ".join(f"{g:.3f}" for g in gaps),
        file=sys.stderr)
    tokens = B * S * len(steps)
    n_params = sum(t.numel() for t in tree_leaves(tr.params))
    flops = model_flops_per_step(model, n_params, B, S)
    obs = {"window_s": window_s, "steps": len(steps),
           "step_s": [lat / 1e9 for _, lat, _ in steps],
           "flops_per_step": flops, "peak_flops": PEAK_BF16_FLOPS,
           "trace": summary}
    decisions, events = list(feeds.decisions), list(feeds.events)
    disp.profiler_feed = feeds.feed
    del tr, feeds, rt, disp
    import gc
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    compared = compare(cell, model, mix, args.seed, B, S, dev, prog,
                       decisions, events)
    return Outcome(
        attempted=len(steps), failed=0,
        end_to_end={"train_tokens_per_s": tokens / window_s,
                    "setup_s": t0 - args.t_start},
        obs=obs, compared=compared,
        device=device_record(dev, 1, peak, summary),
        breakdown=breakdown(summary) if summary else None)


def checked_steps(tr, feeds: DecidingFeed, model: dict, seed: int, dev,
                  n: int, mix: dict, then: Callable[[], None] = None) -> dict:
    """Set the feed's hooks that read the trainer's first ``n`` steps as
    its run takes them: each leaf's first-gradient norm (from the first
    moment after step 1) and each leaf's norm of the change after step
    ``n`` (the initial weights made again, a leaf at a time); ``then``
    runs after that.  The returned readings get each step's loss once the
    run has ended (``losses``)."""
    import torch
    from repro_torch.models.transformer import tree_leaves

    b1 = float(mix["opt"]["b1"])
    prog: dict = {}

    def first():
        prog["grad_norms"] = [float(m.norm()) / (1 - b1)
                              for m in tree_leaves(tr.opt_state["m"])]

    def last():
        with torch.no_grad():
            prog["change_norms"] = [
                float((p.float() - p0).norm()) for p, (_, p0) in
                zip(tree_leaves(tr.params), weights.generate(model, seed, dev))]
        if then is not None:
            then()

    def both():
        first()
        last()
    feeds.hooks.update({1: both} if n == 1 else {1: first, n: last})
    return prog


def losses(tr, prog: dict, n: int) -> dict:
    """The readings with the checked steps' losses from the run's log."""
    return dict(prog, losses=[m["loss"] for m in tr.metrics_log[:n]])


def reference_readings(model, mix, seed, B, S, dev, quantize=False) -> dict:
    corpus = TokenCorpus(model["vocab_size"], data_seed(seed))
    batches = [corpus.batch(i, B, S) for i in range(int(mix["checked_steps"]))]
    W = weights.make(model, seed, dev)
    out = ref_q.train_readings(W, batches, model, mix, quantize)
    del W
    return out


def policy_replay(conf, mix, events, decisions) -> int:
    """Decisions that differ from the reference's replay of the feeds."""
    dep = ref_pol.Deployment(conf)
    d = mix["decide"]
    bad = 0
    for (comm_id, lat, kw), got in zip(events, decisions):
        dep.feed_event(kw.get("coll", 0), kw.get("msg_size", 0), comm_id,
                       lat, kw.get("channels", 0), kw.get("algo", 0))
        want = dep.decide(COLLS[d["coll"]], int(d["bytes"]),
                          int(conf["n_ranks"]), d["axis"])
        bad += decision_fields(got) != want
    return bad


def compare(cell, model, mix, seed, B, S, dev, prog, decisions,
            events) -> List[Compared]:
    lim = mix["limits"][cell.config_name]
    got = ref_q.gaps(prog, reference_readings(model, mix, seed, B, S, dev))
    return [Compared("decision_mismatches",
                     policy_replay(cell.config, mix, events, decisions),
                     lim["decision_mismatches"])] + \
        [Compared(k, got[k], lim[k]) for k in
         ("loss_gap", "grad_norm_gap_median_leaf", "update_norm_gap")]
