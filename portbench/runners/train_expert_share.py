"""Mixes of kind ``train_expert_share``: the port's ``Trainer`` on one
chip's share of an expert-parallel model (the model file's ``deployment``:
the experts this chip holds and its slice of the vocabulary), as the
``train`` kind runs a dense model: bf16 compute over float32 master
weights and AdamW, activation checkpointing on, the mix's deployment of
programs attached to the process-wide dispatcher, one decision after each
step's feed, the window opened after the checked and settling steps of
the one ``Trainer.run`` and closed by the feed after the step that passes
``--seconds``.  ``train_tokens_per_s`` is the window's tokens over its
length.

The model FLOPs of a step count the (token, choice) pairs the held
experts took, which the routing decides: the ``moe.pairs_held`` counter
of the traced window, over the steps it counted.

``correct``: the checked steps against the plain reference
(``reference/moonlight.py``) on the same weights and batches, made again
from the seed after the window, as the ``train`` kind compares them (the
worst step's loss gap, the median leaf's first-gradient norm gap, the
worst moving leaf's change norm gap), the selection biases after the
checked steps (``bias_gap``: the norm of their difference from the
reference's over the norm of the reference's; they have no gradient, so
they are not among the moving leaves), and every decision against the
reference's replay of the policy plane.
"""

from __future__ import annotations

import contextlib
import gc
import json
import sys
import time
from typing import Dict, List

from .. import deploy, moonlight
from ..harness import PKG, ROOT, Compared, Outcome
from ..reference import moonlight as ref_m
from ..reference import qwen3 as ref_q
from ..trace import Tracer, breakdown
from ..traffic import TokenCorpus
from .common import device_record, read_peak
from .train import (DecidingFeed, WindowClosed, data_seed, losses,
                    policy_replay)

PEAK_BF16_FLOPS = 989e12    # H100 SXM data sheet, dense bf16, at 700 W


def port_config(model: dict, sizes: dict):
    """The port's config with the model file's overrides, checked against
    the file: every width, the router's experts and top-k, the experts
    held and the vocabulary slice."""
    from repro_torch.configs import get_config
    cfg = get_config(model["port_config"]).with_overrides(
        **dict(model["port_overrides"], **sizes.get("port_overrides", {})))
    dep = model["deployment"]
    got = (cfg.n_layers, cfg.first_k_dense, cfg.d_model, cfg.n_heads,
           cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
           cfg.v_head_dim, cfg.d_ff, cfg.moe_d_ff, cfg.shared_width,
           cfg.n_experts, cfg.top_k, cfg.held_experts, cfg.vocab,
           cfg.tie_embeddings, cfg.rope_theta, cfg.rms_eps, cfg.router,
           cfg.routed_scale, cfg.bias_rate, cfg.router_aux_coef)
    want = (model["num_hidden_layers"], model["first_k_dense_replace"],
            model["hidden_size"], model["num_attention_heads"],
            model["kv_lora_rank"], model["qk_nope_head_dim"],
            model["qk_rope_head_dim"], model["v_head_dim"],
            model["intermediate_size"], model["moe_intermediate_size"],
            model["moe_intermediate_size"] * model["n_shared_experts"],
            dep["router_experts"], model["num_experts_per_tok"],
            ref_m.held(model), model["vocab_size"],
            model["tie_word_embeddings"], float(model["rope_theta"]),
            model["rms_norm_eps"], model["scoring_func"],
            model["routed_scaling_factor"], model["bias_update_gamma"],
            model["seq_aux_alpha"])
    if got != want or model["q_lora_rank"] is not None:
        raise ValueError(f"the port's {model['port_config']} gives {got}, "
                         f"the model file {want}")
    return cfg


def deployment(mix: dict) -> dict:
    """The configuration file of the policy plane the mix names."""
    return json.loads((PKG / "configs" / f"{mix['deployment']}.json")
                      .read_text())


def pairs_held() -> List[float]:
    """Each held expert's (token, choice) pairs a step, summed over the
    expert layers, from the traced window's ``moe.pairs_held``; [] where
    it counted none."""
    from repro_torch.obs import trace
    c = trace.counter("moe.pairs_held")
    if c is None:
        return []
    return [float(v) / c["additions"] for v in c["total"]]


def run(cell, args) -> Outcome:
    import torch
    from repro_torch.data import DataConfig
    from repro_torch.models.layers import MeshAxes
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.train import (AdamWConfig, Trainer, TrainerConfig,
                                   TrainStepConfig)

    mix = cell.mix
    conf = deployment(mix)
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
    moonlight.fill(tree_leaves(tr.params), model, args.seed, dev)
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
    obs = {"window_s": window_s, "steps": len(steps),
           "step_s": [lat / 1e9 for _, lat, _ in steps],
           "peak_flops": PEAK_BF16_FLOPS, "trace": summary}
    held = pairs_held() if args.trace else []
    if args.trace and not held:
        raise RuntimeError("the traced window counted no moe.pairs_held")
    if held:
        n_layers = model["num_hidden_layers"] - model["first_k_dense_replace"]
        print("pairs held a step per expert and expert layer: " + " ".join(
            f"{p / n_layers:.1f}" for p in held), file=sys.stderr)
        obs["pairs_held"] = held
        obs["flops_per_step"] = moonlight.flops_per_step(model, B, S,
                                                         sum(held))
    decisions, events = list(feeds.decisions), list(feeds.events)
    disp.profiler_feed = feeds.feed
    del tr, feeds, rt, disp
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    compared = compare(conf, model, mix, args.seed, B, S, dev, prog,
                       decisions, events)
    return Outcome(
        attempted=len(steps), failed=0,
        end_to_end={"train_tokens_per_s": B * S * len(steps) / window_s,
                    "setup_s": t0 - args.t_start},
        obs=obs, compared=compared,
        device=device_record(dev, 1, peak, summary),
        breakdown=breakdown(summary) if summary else None)


def checked_steps(tr, feeds: DecidingFeed, model: dict, seed: int, dev,
                  n: int, mix: dict) -> dict:
    """Set the feed's hooks that read the trainer's first ``n`` steps:
    each leaf's first-gradient norm (from the first moment after step 1)
    and, after step ``n``, each leaf's norm of the change (the initial
    weights made again, a leaf at a time) and the selection biases."""
    import torch
    from repro_torch.models.transformer import router_biases, tree_leaves

    b1 = float(mix["opt"]["b1"])
    prog: dict = {}

    def first():
        prog["grad_norms"] = [float(m.norm()) / (1 - b1)
                              for m in tree_leaves(tr.opt_state["m"])]

    def last():
        with torch.no_grad():
            prog["change_norms"] = [
                float((p.float() - p0).norm()) for p, (_, p0) in
                zip(tree_leaves(tr.params), moonlight.generate(model, seed,
                                                               dev))]
            prog["bias"] = torch.stack(router_biases(tr.params, tr.cfg)
                                       ).float().cpu()

    def both():
        first()
        last()
    feeds.hooks.update({1: both} if n == 1 else {1: first, n: last})
    return prog


def reference_readings(model, mix, seed, B, S, dev, quantize=False) -> dict:
    corpus = TokenCorpus(model["vocab_size"], data_seed(seed))
    batches = [corpus.batch(i, B, S) for i in range(int(mix["checked_steps"]))]
    W = moonlight.make(model, seed, dev)
    out = ref_m.train_readings(W, batches, model, mix, quantize)
    del W
    return out


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The ``train`` kind's three gaps and ``bias_gap``, the selection
    biases' distance from the reference's, ``|b - b_ref| / |b_ref|``: a
    bias update left out reads 1, one of the wrong sign about 2."""
    b, want = prog["bias"].float().cpu(), ref["bias"].float().cpu()
    scale = max(float(want.norm()), 1e-30)
    return dict(ref_q.gaps(prog, ref),
                bias_gap=float((b - want).norm()) / scale)


def compare(conf, model, mix, seed, B, S, dev, prog, decisions,
            events) -> List[Compared]:
    lim = mix["limits"]
    got = gaps(prog, reference_readings(model, mix, seed, B, S, dev))
    return [Compared("decision_mismatches",
                     policy_replay(conf, mix, events, decisions),
                     lim["decision_mismatches"])] + \
        [Compared(k, got[k], lim[k]) for k in
         ("loss_gap", "grad_norm_gap_median_leaf", "update_norm_gap",
          "bias_gap")]
