"""Tensor parallelism through the policy dispatcher: smoke forwards at
``tp=2`` over 2 ``gloo`` ranks against the reference's ``tp=1`` logits.

The reference's ``tp=1`` weights are cut by the port's specs (each dim
whose spec names ``model`` split in two, ``MeshAxes(tp=2, fsdp=False)``):
the vocab-parallel embedding and head, column-parallel q/k/v (and their
biases) and MLP up projections, row-parallel output projections.  The
model's all-reduces (embedding, attention and MLP outputs) and the logits'
all-gather go through the port's ``CollectiveDispatcher`` — with no tuner
attached (the native collective) and with ``static_override`` (the ring
algorithm over point-to-point sends).  Logits within 1e-4 of the
reference's rms, as in the f32 forward checks.
"""

import multiprocessing as mp
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.models as R
from repro.configs import get_smoke_config as ref_smoke
from repro.models.layers import MeshAxes as RefAxes

N = 2
ARCHS = ["tinyllama-1.1b", "qwen2.5-32b"]
POLICIES = [None, "static_override"]
B, S = 2, 16


def _cut(tree, specs, rank: int, tp: int):
    """This rank's slice of ``tree``: dims whose spec names ``model``
    split in ``tp`` equal parts."""
    if isinstance(tree, dict):
        return {k: _cut(v, specs[k], rank, tp) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cut(v, s, rank, tp) for v, s in zip(tree, specs)]
    for dim, axis in enumerate(specs):
        if axis == "model":
            tree = np.split(tree, tp, axis=dim)[rank]
    return np.ascontiguousarray(tree)


def rank_main(rank: int, port: int, q, jobs) -> None:
    try:
        q.put((rank, _rank_body(rank, port, jobs)))
    except Exception:       # reported to the parent, which fails the test
        import traceback
        q.put((rank, {"error": traceback.format_exc()}))


def _rank_body(rank: int, port: int, jobs) -> dict:
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.collectives.dispatch import reset_dispatcher
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import PolicyRuntime
    from repro_torch.models import forward_logits, init_params, loss_fn
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.layers import MeshAxes
    import repro_torch.policies as pol

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=N, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        ax = MeshAxes(tp=N, dp=1, fsdp=False)
        for arch, policy, params_np, tokens in jobs:
            cfg = get_smoke_config(arch).with_overrides(dtype="float32")
            _, specs = init_params(0, cfg, ax, device="cpu")
            params = params_from_numpy(_cut(params_np, specs, rank, N),
                                       device="cpu")
            rt = PolicyRuntime(tier="torch")
            if policy:
                rt.load(getattr(pol, policy).program)
            disp = reset_dispatcher(runtime=rt)
            batch = {"tokens": torch.from_numpy(tokens)}
            with torch.no_grad():
                logits, _ = forward_logits(params, batch, cfg, ax)
            decisions = [(d.coll, d.algo, d.proto, d.from_policy)
                         for d in list(disp.decisions)]
            # gradients flow through the dispatcher's collectives (the
            # training slice): every attention leaf of the first period
            # gets a finite gradient
            leaves = list(params["blocks"][0]["attn"].values())
            for leaf in leaves:
                leaf.requires_grad_(True)
            try:
                loss = loss_fn(params, dict(batch, labels=batch["tokens"]),
                               cfg, ax)
                grads = torch.autograd.grad(loss, leaves)
                grad_guard = "no error" if all(
                    bool(torch.isfinite(g).all()) for g in grads) \
                    else "non-finite gradient"
            except Exception as e:
                grad_guard = f"{type(e).__name__}: {e}"
            for leaf in leaves:
                leaf.requires_grad_(False)
            out[(arch, policy)] = {"logits": logits.numpy(),
                                   "decisions": decisions,
                                   "grad_guard": grad_guard}
    finally:
        dist.destroy_process_group()
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs():
    """({arch: reference tp=1 logits}, {rank: {(arch, policy): record}})."""
    ref, jobs = {}, []
    for arch in ARCHS:
        cfg = ref_smoke(arch).with_overrides(dtype="float32")
        ax = RefAxes(tp=1, dp=1, fsdp=False)
        params, _ = R.init_params(jax.random.PRNGKey(0), cfg, ax)
        tokens = np.random.RandomState(7).randint(
            0, cfg.vocab, (B, S)).astype(np.int32)
        logits, _ = R.forward_logits(params, {"tokens": jnp.asarray(tokens)},
                                     cfg, ax)
        ref[arch] = np.asarray(logits)
        for policy in POLICIES:
            jobs.append((arch, policy, jax.tree.map(np.asarray, params),
                         tokens))
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=rank_main, args=(r, port, q, jobs))
             for r in range(N)]
    for p in procs:
        p.start()
    try:
        ranks = dict(q.get(timeout=300) for _ in range(N))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    for r, rec in ranks.items():
        assert "error" not in rec, f"rank {r}:\n{rec['error']}"
    return ref, ranks


@pytest.mark.parametrize("policy", POLICIES, ids=["native", "ring"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp2_logits_equal_the_reference_tp1(runs, arch, policy):
    ref, ranks = runs
    want = ref[arch]
    tol = 1e-4 * float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    for r in range(N):
        got = ranks[r][(arch, policy)]["logits"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= tol, (r, np.abs(got - want).max())


@pytest.mark.parametrize("policy", POLICIES, ids=["native", "ring"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_collectives_go_through_the_dispatcher(runs, arch, policy):
    from repro_torch.core.context import Algo, CollType
    _, ranks = runs
    for r in range(N):
        dec = ranks[r][(arch, policy)]["decisions"]
        colls = [c for c, _, _, _ in dec]
        # embedding + (attention, MLP) per layer all-reduced; logits
        # gathered once
        n_layers = ref_smoke(arch).n_layers
        assert colls.count(CollType.ALL_REDUCE) == 1 + 2 * n_layers
        assert colls.count(CollType.ALL_GATHER) == 1
        if policy == "static_override":
            assert all(a == Algo.RING and p == 0 and fp
                       for _, a, p, fp in dec), dec
        else:
            assert not any(fp for _, _, _, fp in dec)


def test_gradients_over_tp_raise_until_the_training_slice(runs):
    """The training slice has landed: gradients through the ``tp = 2``
    collectives no longer raise, on every rank and config
    (``tests/test_torch_train_mesh.py`` holds their values)."""
    _, ranks = runs
    for r in range(N):
        for key, rec in ranks[r].items():
            assert rec["grad_guard"] == "no error", (r, key,
                                                     rec["grad_guard"])


def test_fsdp_gathers_raise_until_the_training_slice():
    """FSDP gathers are the identity without the data axis, and reach
    ``torch.distributed`` with it (no process group here, so that call
    fails; ``tests/test_torch_train_mesh.py`` runs them on 2 ranks)."""
    import torch

    from repro_torch.collectives.dispatch import reset_dispatcher
    from repro_torch.models.layers import MeshAxes, fsdp_gather
    reset_dispatcher(tier="torch")
    w = torch.zeros(4, 2)
    assert fsdp_gather(w, MeshAxes(dp=1), 0) is w
    assert fsdp_gather(w, MeshAxes(dp=2, fsdp=False), 0) is w
    with pytest.raises((ValueError, RuntimeError), match="process group"):
        fsdp_gather(w, MeshAxes(dp=2), 0)
