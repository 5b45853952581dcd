"""Stacked weight leaves under autograd, on the CPU.

Each position of a period keeps its layers' weights in one leaf stacked
along dimension 0.  A differentiated forward takes every such leaf
apart with one ``unbind`` before the layer loop, so the backward writes
the leaf's gradient with one ``stack``.  Indexing the leaf per layer
(``a[i]``) gives the same values, but its backward zero-fills a tensor
the size of the whole stack and adds it into the leaf's gradient at
every layer: L fills and L - 1 adds of the stack for L layers.

Goldens: sha256 digests of every gradient leaf (``loss_and_grads``) and
of every parameter after one AdamW step, from the port as it was when
each layer indexed its stacked leaf.  A digest reads ``t + 0.0``, which
turns -0.0 into 0.0: ``torch.equal`` holds the two signs of zero equal,
and AdamW maps both to the same parameter."""

import hashlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import moonlight
from portbench.tests.small_moonlight import (port_tree, small_config,
                                             small_model)
from portbench.traffic import TokenCorpus
from repro_torch.collectives.dispatch import reset_dispatcher
from repro_torch.configs import get_smoke_config
from repro_torch.core.runtime import PolicyRuntime
from repro_torch.launch.specs import param_shapes_and_specs
from repro_torch.models import init_params
from repro_torch.models.layers import MeshAxes
from repro_torch.models.transformer import BufferSpec, tree_leaves
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.step import (TrainStepConfig, loss_and_grads,
                                    make_train_step, spec_leaves)

AX = MeshAxes()
SEED = 2**31 + 31


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update((t.detach() + 0.0).contiguous().numpy().tobytes())
    return h.hexdigest()[:32]


def _dense(dtype: str, remat: bool):
    """A Qwen3 smoke model four layers deep: (cfg, params, specs, batch)."""
    cfg = get_smoke_config("qwen3-1.7b").with_overrides(
        n_layers=4, dtype=dtype, remat=remat)
    params, specs = init_params(7, cfg, AX, device="cpu")
    tok = torch.randint(0, cfg.vocab, (2, 33),
                        generator=torch.Generator().manual_seed(11))
    return cfg, params, specs, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _moonlight(dtype: str, remat: bool):
    """The small Moonlight block (a leading dense layer, two expert
    layers holding 4 of 16 experts) with a selection bias that moves the
    routing: (cfg, params, specs, batch)."""
    model = small_model()
    cfg = small_config(model, dtype=dtype, remat=remat)
    W = moonlight.make(model, SEED, "cpu")
    b = W["blocks.0.moe.router_bias"]
    b.copy_(torch.randn(b.shape, generator=torch.Generator().manual_seed(5))
            * 0.05)
    _, specs = param_shapes_and_specs(cfg, AX)
    batch = TokenCorpus(model["vocab_size"], 5).batch(0, 2, 32)
    return cfg, port_tree(W), specs, {k: torch.as_tensor(v)
                                      for k, v in batch.items()}


MODELS = {"dense": _dense, "moonlight": _moonlight}

# (gradients, parameters after one AdamW step), from the port before
# each forward unbound its stacked leaves once
GOLDEN = {
    ("dense", "float32", False): ("1a1fb901698921d84cd30602a03519aa",
                                  "f5fff662dd6c5f891fae88587c7dde82"),
    ("dense", "float32", True): ("1a1fb901698921d84cd30602a03519aa",
                                 "f5fff662dd6c5f891fae88587c7dde82"),
    ("dense", "bfloat16", True): ("e231e11ae6ac4ac9c82c3381b018f261",
                                  "4326b09108660c5a36c977ca7fbeecb2"),
    ("moonlight", "float32", True): ("5fd5c315df79ba1c5c80c3375b50a1ac",
                                     "ac7b78e487b6e4fa690093436a28f588"),
    ("moonlight", "bfloat16", True): ("d758aff94883962a2587ec65e137c992",
                                      "5f1b2e0b95868e69b51eba1b2e46216d"),
}


def _readings(name, dtype, remat):
    reset_dispatcher(runtime=PolicyRuntime(tier="jit"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg, params, specs, batch = MODELS[name](dtype, remat)
        loads = [] if cfg.router == "sigmoid" else None
        _, grads = loss_and_grads(params, batch, cfg, AX, specs,
                                  loads=loads)
        step, _ = make_train_step(cfg, AX, None, specs, TrainStepConfig())
        params, _, _ = step(params, adamw_init(params), batch)
        return _digest(tree_leaves(grads)), _digest(tree_leaves(params))
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name,dtype,remat", sorted(GOLDEN))
def test_gradients_and_step_are_bit_identical_to_indexing(name, dtype,
                                                           remat):
    grads, params = _readings(name, dtype, remat)
    want_grads, want_params = GOLDEN[(name, dtype, remat)]
    assert grads == want_grads
    assert params == want_params


def _stacked(params, specs) -> list:
    """The leaves stacked by layer that take a gradient."""
    return [a for key in ("blocks", "tail", "dense", "final_norm")
            if key in params
            for a, s in zip(tree_leaves(params[key]), spec_leaves(specs[key]))
            if not isinstance(s, BufferSpec)]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_backward_writes_each_stacked_gradient_once(name):
    """Under remat: no ``select_backward`` from a stacked leaf (a zero
    fill and an add of the whole stack a layer), and at most one
    ``stack`` per stacked leaf that takes a gradient.  Selects of other
    tensors stay: the loss picks each label's log-probability from an
    activation, and the expert layer takes each held expert's weights
    from its layer's slice."""
    reset_dispatcher(runtime=PolicyRuntime(tier="jit"))
    cfg, params, specs, batch = MODELS[name]("float32", True)
    stacked = _stacked(params, specs)
    assert max(a.shape[0] for a in stacked) >= 2
    loads = [] if cfg.router == "sigmoid" else None
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        loss_and_grads(params, batch, cfg, AX, specs, loads=loads)
    # select_backward(grad, input_sizes, dim, index): the sizes of the
    # tensor the forward selected from
    shapes = [list(a.shape) for a in stacked]
    selected = [list(e.concrete_inputs[1]) for e in prof.events()
                if e.name == "aten::select_backward"]
    stacks = sum(e.name == "aten::stack" for e in prof.events())
    assert [s for s in selected if s in shapes] == []
    assert 0 < stacks <= len(stacked)
