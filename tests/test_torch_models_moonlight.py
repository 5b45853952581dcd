"""Moonlight-16B-A3B's DeepSeek-V3 block in the port against the plain
reference (``portbench/reference/moonlight.py``) on seeded weights, on the
CPU, in float32, at a small size (a dense layer, two expert layers, 16
routed experts of which 4 are held, top-4): latent attention alone, the
expert layer alone, three training steps, a routing skewed onto the held
experts with nothing dropped, the four shares adding up to the uncut
layer.  And the shared code the block changed: the Qwen3 and OLMoE smoke
numerics are bit-identical to the values the port gave before it."""

import numpy as np
import pytest
import torch

from portbench import moonlight
from portbench.reference import moonlight as ref
from portbench.tests.small_moonlight import (port_tree, small_config,
                                             small_model)
from portbench.traffic import TokenCorpus
from repro_torch.collectives.dispatch import reset_dispatcher
from repro_torch.core.runtime import PolicyRuntime
from repro_torch.models.attention import mla_train
from repro_torch.models.layers import MeshAxes
from repro_torch.models.moe import held_moe_block
from repro_torch.models.transformer import _layer, router_biases

AX = MeshAxes()
SEED = 2**31 + 29


def _weights(model, seed=SEED, bias=True):
    """The plan's weights, with a selection bias that moves the routing."""
    W = moonlight.make(model, seed, "cpu")
    if bias:
        g = torch.Generator().manual_seed(seed % 1000)
        b = W["blocks.0.moe.router_bias"]
        b.copy_(torch.randn(b.shape, generator=g) * 0.05)
    return W


def _hidden(model, B=2, S=32, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, S, model["hidden_size"], generator=g)


def test_latent_attention_equals_the_reference():
    model = small_model()
    cfg = small_config(model)
    W = _weights(model)
    tree = port_tree(W)
    h = _hidden(model)
    for i in range(2):
        got = mla_train(_layer(tree["blocks"][0], i)["attn"], h, cfg, AX)
        want = torch.cat([ref.mla(h[b:b + 1], W, "blocks.0.", i, model,
                                  False) for b in range(h.shape[0])])
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _expert_layer(model, W, h, i=0):
    """(port out, port aux, port counts), (reference out, aux, counts)
    for expert layer ``i`` on ``h``."""
    cfg = small_config(model)
    loads = []
    y, aux = held_moe_block(_layer(port_tree(W)["blocks"][0], i)["moe"], h,
                            cfg, AX, loads)
    outs = [ref.experts(h[b:b + 1], W, i, model, False)
            for b in range(h.shape[0])]
    want = (torch.cat([o[0] for o in outs]),
            model["seq_aux_alpha"] * torch.stack([o[1] for o in outs]).mean(),
            sum(o[2] for o in outs))
    return (y, aux, loads[0]), want


def test_expert_layer_equals_the_reference():
    model = small_model()
    (y, aux, load), (wy, waux, wload) = _expert_layer(
        model, _weights(model), _hidden(model))
    torch.testing.assert_close(y, wy, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(aux, waux, rtol=1e-5, atol=0)
    assert torch.equal(load, wload)
    assert float(load.sum()) == 2 * 32 * model["num_experts_per_tok"]


def test_routing_skewed_onto_the_held_experts_drops_nothing():
    """A bias that makes every token choose the four held experts: every
    (token, choice) pair is held, four times what a capacity of 1.25 of
    the fair share would keep, and the result is the reference's."""
    model = small_model()
    W = _weights(model, bias=False)
    W["blocks.0.moe.router_bias"][:, :4] = 10.0
    h = _hidden(model)
    (y, _, load), (wy, _, wload) = _expert_layer(model, W, h)
    T = h.shape[0] * h.shape[1]
    assert load[:4].tolist() == [T] * 4 and float(load[4:].sum()) == 0
    torch.testing.assert_close(y, wy, rtol=1e-5, atol=1e-6)
    # every held expert took part: its weights change the result
    W["blocks.0.moe.w2"][0, 3] *= 2
    (y2, _, _), _ = _expert_layer(model, W, h)
    assert not torch.allclose(y, y2)


def test_the_shares_add_up_to_the_uncut_layer():
    """The routed parts of the four shares, plus the shared experts
    counted once, are the reference's layer holding all 16 experts."""
    whole = small_model()
    whole["n_routed_experts"] = 16
    W = _weights(whole)
    h = _hidden(whole)
    want = torch.cat([ref.experts(h[b:b + 1], W, 0, whole, False)[0]
                      for b in range(h.shape[0])])
    tree = port_tree(W)
    p = _layer(tree["blocks"][0], 0)["moe"]
    shared = None
    total = torch.zeros_like(h)
    for r in range(4):
        cfg = small_config(small_model(first_expert=4 * r))
        share = dict(p, **{k: p[k][4 * r:4 * r + 4]
                           for k in ("w1", "w2", "w3")})
        y, _ = held_moe_block(share, h, cfg, AX)
        no_routed = dict(share, w2=torch.zeros_like(share["w2"]))
        shared, _ = held_moe_block(no_routed, h, cfg, AX)
        total = total + (y - shared)
    torch.testing.assert_close(total + shared, want, rtol=1e-5, atol=1e-5)


def test_three_training_steps_equal_the_reference():
    """Loss of each step, each leaf's first clipped gradient, each leaf's
    change after three steps, and the selection biases the sign rule
    moved, against the reference's AdamW and bias update."""
    from portbench.tests.small_moonlight import cell
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.step import TrainStepConfig, make_train_step
    from repro_torch.launch.specs import param_shapes_and_specs
    from repro_torch.models.transformer import tree_leaves
    reset_dispatcher(runtime=PolicyRuntime(tier="jit"))
    model, mix = small_model(), cell().mix
    cfg = small_config(model, remat=True)
    corpus = TokenCorpus(model["vocab_size"], 5)
    batches = [corpus.batch(i, 2, 32) for i in range(3)]
    W = _weights(model, bias=False)
    want = ref.train_readings({k: v.clone() for k, v in W.items()}, batches,
                              model, mix)
    params = port_tree({k: v.clone() for k, v in W.items()})
    # one rank: every leaf whole; the port's own specs mark the biases
    # as buffers
    _, specs = param_shapes_and_specs(cfg, AX)
    step, _ = make_train_step(cfg, AX, None, specs, TrainStepConfig(
        opt=AdamWConfig(**mix["opt"]), total_steps=mix["total_steps"],
        warmup_steps=mix["warmup_steps"]))
    opt = adamw_init(params)
    losses = []
    for i, b in enumerate(batches):
        params, opt, m = step(params, opt, {k: torch.as_tensor(v)
                                            for k, v in b.items()})
        losses.append(float(m["loss"]))
        if i == 0:
            grads = [float(t.norm()) / (1 - mix["opt"]["b1"])
                     for t in tree_leaves(opt["m"])]
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    np.testing.assert_allclose(grads, want["grad_norms"], rtol=1e-4,
                               atol=1e-7)
    change = [float((p - W[n]).norm()) for p, n in
              zip(tree_leaves(params), want["names"])]
    np.testing.assert_allclose(change, want["change_norms"], rtol=1e-4,
                               atol=1e-8)
    biases = torch.stack(router_biases(params, cfg))
    assert torch.equal(biases, want["bias"])
    assert float(biases.abs().sum()) > 0


# ---------------------------------------------------------------------------
# the shared code: bit-identical numerics for the models that were there
# ---------------------------------------------------------------------------

# the f32 loss; two train steps' losses, the parameters' sum and the
# second moment's absolute sum after them; then the same in bf16 under
# remat, as float.hex, from the port before latent attention, the held
# expert layer and the leaf-at-a-time AdamW went in
BEFORE = {
    "qwen3-1.7b": [
        "0x1.947d7a0000000p+2", "0x1.947d7a0000000p+2",
        "0x1.940b860000000p+2", "0x1.6ea83404001afp+10",
        "0x1.8f5c27e8a8052p-4", "0x1.9480060000000p+2",
        "0x1.9480060000000p+2", "0x1.9410e80000000p+2",
        "0x1.6ea831e57e0aep+10", "0x1.8f5c282e6209ep-4"],
    "olmoe-1b-7b": [
        "0x1.9ae4ec0000000p+2", "0x1.9ae4ec0000000p+2",
        "0x1.9a7b2e0000000p+2", "0x1.6c1e798fc7274p+10",
        "0x1.8f5c2a3f06021p-4", "0x1.9ac0680000000p+2",
        "0x1.9ac0680000000p+2", "0x1.9a76060000000p+2",
        "0x1.6c1e9d4f57525p+10", "0x1.8f5c2873a362ap-4"],
}


@pytest.mark.parametrize("arch", sorted(BEFORE))
def test_smoke_numerics_are_bit_identical_to_before(arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import TrainStepConfig, make_train_step
    reset_dispatcher(runtime=PolicyRuntime(tier="jit"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = []
        for dtype, remat in (("float32", False), ("bfloat16", True)):
            cfg = get_smoke_config(arch).with_overrides(dtype=dtype,
                                                        remat=remat)
            p, specs = init_params(7, cfg, AX, device="cpu")
            tok = torch.randint(0, cfg.vocab, (2, 33),
                                generator=torch.Generator().manual_seed(11))
            batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
            out.append(float(loss_fn(p, batch, cfg, AX)).hex())
            step, _ = make_train_step(cfg, AX, None, specs,
                                      TrainStepConfig())
            o = adamw_init(p)
            for _ in range(2):
                p, o, m = step(p, o, batch)
                out.append(float(m["loss"]).hex())
            out.append(float(sum(t.double().sum()
                                 for t in tree_leaves(p))).hex())
            out.append(float(sum(t.double().abs().sum()
                                 for t in tree_leaves(o["v"]))).hex())
    finally:
        torch.set_num_threads(threads)
    assert out == BEFORE[arch]
