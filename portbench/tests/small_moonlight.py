"""The Moonlight cell at a size a CPU test can hold: a dense layer and
two expert layers, 16 routed experts of which 4 are held, top-4; the
plain reference's weights as the port's parameter tree; and the faults
of the selection biases' update, planted as ``faults.py`` plants its own
(``FAULTS`` here is merged into that module's table by whoever plants
one)."""

from portbench import harness

CELL = "adaptive-loop.train-moonlight-16b-a3b"
SMALL = {
    "model": {"num_hidden_layers": 3, "hidden_size": 128,
              "num_attention_heads": 4, "num_key_value_heads": 4,
              "kv_lora_rank": 32, "qk_nope_head_dim": 16,
              "qk_rope_head_dim": 8, "v_head_dim": 16,
              "intermediate_size": 256, "moe_intermediate_size": 64,
              "n_routed_experts": 4, "num_experts_per_tok": 4,
              "vocab_size": 512,
              "deployment": {"router_experts": 16, "first_expert": 0}},
    "port_overrides": {"n_layers": 3, "d_model": 128, "n_heads": 4,
                       "n_kv_heads": 4, "d_ff": 256, "vocab": 512,
                       "n_experts": 16, "top_k": 4, "moe_d_ff": 64,
                       "shared_d_ff": 128, "kv_lora_rank": 32,
                       "qk_nope_dim": 16, "qk_rope_dim": 8,
                       "v_head_dim": 16, "n_experts_held": 4},
    "batch": 2, "seq": 64, "window_steps": 2}


def cell():
    return harness.find_cell(harness.load_bench(), CELL)


def small_model(**deployment) -> dict:
    """The cell's model file at the small size; ``deployment`` replaces
    keys of its deployment (``first_expert``)."""
    m = dict(cell().model, **SMALL["model"])
    m["deployment"] = dict(m["deployment"], **deployment)
    return m


def small_config(model: dict, **kw):
    """The port's config for ``model`` (the share its deployment's
    ``first_expert`` begins), float32 unless ``kw`` says."""
    from portbench.runners import train_expert_share as drv
    shard = model["deployment"]["first_expert"] // model["n_routed_experts"]
    cfg = drv.port_config(model, {"port_overrides": dict(
        SMALL["port_overrides"], expert_shard=shard)})
    return cfg.with_overrides(**dict(dict(dtype="float32", remat=False),
                                     **kw))


def port_tree(W: dict):
    """The reference's leaves (``moonlight.plan`` paths) as the port's
    tree; the tensors are shared."""
    tree = {}
    for path, t in W.items():
        node = tree
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return dict(tree, blocks=[tree["blocks"]["0"]], tail=[])


def skipped_bias_update():
    """The selection biases left where they are: the step runs no sign
    rule."""
    from repro_torch.train import step as st
    old = st.update_router_bias
    st.update_router_bias = lambda *a, **kw: None
    return lambda: setattr(st, "update_router_bias", old)


def reversed_bias_update():
    """The sign rule turned round: each bias moves away from the mean
    load."""
    from repro_torch.train import step as st
    old = st.update_router_bias

    def reversed_(biases, *a, **kw):
        before = [b.clone() for b in biases]
        old(biases, *a, **kw)
        for b, b0 in zip(biases, before):
            b.mul_(-1).add_(b0, alpha=2)
    st.update_router_bias = reversed_
    return lambda: setattr(st, "update_router_bias", old)


FAULTS = {"skipped_bias_update": skipped_bias_update,
          "reversed_bias_update": reversed_bias_update}
