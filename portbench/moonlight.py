"""What the harness knows of the Moonlight model (``models/
moonlight-16b-a3b.json``) beyond its file: the weight plan, in the port's
parameter tree order, and the model FLOPs of a training step.

The weights are made as ``weights.py`` makes them, by one generator from
the seed on the card, a leaf at a time in plan order: every matrix normal
with std ``initializer_range``, every norm scale 1, each expert layer's
selection bias 0.
"""

from __future__ import annotations

from typing import List, Tuple

from .weights import weight_seed


def plan(model: dict) -> List[Tuple[str, tuple, str]]:
    """(path, shape, kind) of every leaf; kind ``normal``, ``ones`` or
    ``zeros``.  The expert layers are stacked under ``blocks.0``, the
    leading dense layers under ``dense``."""
    Ld = model["first_k_dense_replace"]
    L = model["num_hidden_layers"] - Ld
    D, H = model["hidden_size"], model["num_attention_heads"]
    dn, dr = model["qk_nope_head_dim"], model["qk_rope_head_dim"]
    dv, R = model["v_head_dim"], model["kv_lora_rank"]
    F, Fe = model["intermediate_size"], model["moe_intermediate_size"]
    Fs = Fe * model["n_shared_experts"]
    E = model["deployment"]["router_experts"]
    En, V = model["n_routed_experts"], model["vocab_size"]
    if model["tie_word_embeddings"] or model["q_lora_rank"] is not None:
        raise ValueError("plan() covers untied embeddings and no query "
                         "LoRA only")

    def attn(p, n):
        return [(p + "attn.kv_norm", (n, R), "ones"),
                (p + "attn.wkv_a", (n, D, R + dr), "normal"),
                (p + "attn.wkv_b", (n, R, H * (dn + dv)), "normal"),
                (p + "attn.wo", (n, H * dv, D), "normal"),
                (p + "attn.wq", (n, D, H * (dn + dr)), "normal"),
                (p + "ln1.scale", (n, D), "ones"),
                (p + "ln2.scale", (n, D), "ones")]

    m = "blocks.0.moe."
    return attn("blocks.0.", L) + [
        (m + "router", (L, D, E), "normal"),
        (m + "router_bias", (L, E), "zeros"),
        (m + "shared_w1", (L, D, Fs), "normal"),
        (m + "shared_w2", (L, Fs, D), "normal"),
        (m + "shared_w3", (L, D, Fs), "normal"),
        (m + "w1", (L, En, D, Fe), "normal"),
        (m + "w2", (L, En, Fe, D), "normal"),
        (m + "w3", (L, En, D, Fe), "normal")] + attn("dense.", Ld) + [
        ("dense.mlp.w_down", (Ld, F, D), "normal"),
        ("dense.mlp.w_gate", (Ld, D, F), "normal"),
        ("dense.mlp.w_up", (Ld, D, F), "normal"),
        ("embed", (V, D), "normal"),
        ("final_norm.scale", (1, D), "ones"),
        ("lm_head", (V, D), "normal")]


def generate(model: dict, seed: int, device):
    """Each leaf's initial values, ``(path, float32 tensor)`` in plan
    order."""
    import torch
    g = torch.Generator(device=device).manual_seed(weight_seed(seed))
    std = float(model["initializer_range"])
    for path, shape, kind in plan(model):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        if kind == "normal":
            t.normal_(0.0, std, generator=g)
        else:
            t.fill_(1.0 if kind == "ones" else 0.0)
        yield path, t


def fill(tensors, model: dict, seed: int, device) -> None:
    """Copy the weights into ``tensors`` (the trainer's leaves, in plan
    order)."""
    import torch
    with torch.no_grad():
        for t, (path, w) in zip(tensors, generate(model, seed, device)):
            if t.shape != w.shape:
                raise ValueError(f"{path}: {tuple(t.shape)} against the "
                                 f"plan's {tuple(w.shape)}")
            t.copy_(w)


def make(model: dict, seed: int, device) -> dict:
    """The weights as ``{path: tensor}``, float32 on ``device``."""
    return dict(generate(model, seed, device))


def flops_per_step(model: dict, batch: int, seq: int,
                   pairs_held: float) -> float:
    """Model FLOPs of a training step: 6 T times the weights every token
    goes through (latent attention's projections, the dense layer's
    SwiGLU, the shared experts, the router, the head; not the input
    embedding, a lookup, nor the norm scales), 6 times a held expert's
    weights for each (token, choice) pair the held experts took
    (``pairs_held``, summed over the expert layers), and the attention
    scores and their product with v over every key, 6 H (192 + 128) S T
    a layer.  Recomputation under activation checkpointing is not
    counted."""
    T = batch * seq
    Ld = model["first_k_dense_replace"]
    L = model["num_hidden_layers"]
    D, H = model["hidden_size"], model["num_attention_heads"]
    dn, dr = model["qk_nope_head_dim"], model["qk_rope_head_dim"]
    dv, R = model["v_head_dim"], model["kv_lora_rank"]
    F, Fe = model["intermediate_size"], model["moe_intermediate_size"]
    Fs = Fe * model["n_shared_experts"]
    E = model["deployment"]["router_experts"]
    attn = D * H * (dn + dr) + D * (R + dr) + R * H * (dn + dv) + H * dv * D
    per_token = L * attn + Ld * 3 * D * F + (L - Ld) * (3 * D * Fs + D * E) \
        + model["vocab_size"] * D
    return 6.0 * per_token * T + 6.0 * 3 * D * Fe * pairs_held \
        + 6.0 * L * H * (dn + dr + dv) * seq * T
