"""The port's training substrate (``repro_torch.data``, ``repro_torch.train``)
on the CPU: every case of ``tests/test_train.py`` on the port, then
parity with the reference on the same numpy-seeded inputs.

Tolerances, each against the reference's own output:

- data batches: bit-equal (the same numpy calls in the same order);
- schedule and AdamW on random trees: 1e-6 relative (f32 in the same
  order of operations; the two libraries' ``pow``, ``cos``, ``sqrt``
  and sums may differ in the last bit);
- checkpoints: bit-equal leaves across the two packages, both ways;
- one f32 train step on a 1-device mesh: loss, ``grad_norm``, ``lr`` and
  every updated parameter, ``m`` and ``v`` leaf within 1e-5 relative (in
  norm) of the reference's ``make_train_step`` (the gradients differ in
  summation order only, ``tests/torch_models_check.py``); a parameter's
  elements whose gradient lies within 100 eps of zero are held through
  ``m`` and ``v`` only (the test says why);
- remat off, on and ``save_psum``: the same gradients within 1e-6
  relative (the recompute runs the same ops on the same inputs).
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.models as R
from repro.collectives.dispatch import reset_dispatcher as ref_reset
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.core.runtime import PolicyRuntime as RefRuntime
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLMDataset as RefDataset
from repro.models.layers import MeshAxes as RefAxes
from repro.train import TrainStepConfig as RefStepConfig
from repro.train import make_train_step as ref_make_train_step
from repro.train.checkpoint import load_checkpoint as ref_load
from repro.train.checkpoint import save_checkpoint as ref_save
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro.train.optimizer import adamw_update as ref_adamw_update
from repro.train.schedule import cosine_schedule as ref_cosine
from repro.train.schedule import linear_warmup as ref_warmup

from repro_torch.collectives.dispatch import reset_dispatcher
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.runtime import PolicyRuntime
from repro_torch.data import DataConfig, SyntheticLMDataset, make_dataset
from repro_torch.models import init_params, loss_fn
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import MeshAxes
from repro_torch.models.transformer import tree_flatten, tree_map
from repro_torch.train import (AdamWConfig, Trainer, TrainerConfig,
                               TrainStepConfig, make_train_step)
from repro_torch.train.checkpoint import (latest_step, load_checkpoint,
                                          save_checkpoint)
from repro_torch.train.optimizer import adamw_init, adamw_update
from repro_torch.train.schedule import cosine_schedule, linear_warmup

AX1 = MeshAxes(tp=1, dp=1, fsdp=False)
REF_AX1 = RefAxes(tp=1, dp=1, fsdp=False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The steps here are small, so torch's intra-op threads only wait on
    the other test workers' (beside 6 busy processes on 8 cores, 30 steps
    took 59 s with 8 threads and 10.5 s with 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runtime():
    rt = PolicyRuntime(tier="torch")
    reset_dispatcher(runtime=rt)
    return rt


def _trainer(cfg, tcfg):
    return Trainer(cfg, AX1, None, tcfg, device="cpu")


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


# ---------------------------------------------------------------------------
# the cases of tests/test_train.py, on the port
# ---------------------------------------------------------------------------

def test_loss_decreases_tinyllama():
    _runtime()
    cfg = get_smoke_config("tinyllama-1.1b").with_overrides(vocab=512)
    tcfg = TrainerConfig(
        steps=30, log_every=100,
        data=DataConfig(seq_len=64, global_batch=8, seed=0),
        step=TrainStepConfig(opt=AdamWConfig(lr=1e-3), total_steps=30,
                             warmup_steps=5))
    log = _trainer(cfg, tcfg).run()
    first = np.mean([m["loss"] for m in log[:5]])
    last = np.mean([m["loss"] for m in log[-5:]])
    assert last < first - 0.2, f"no learning: {first:.3f} -> {last:.3f}"


def test_moe_training_step_runs():
    _runtime()
    cfg = get_smoke_config("olmoe-1b-7b")
    tcfg = TrainerConfig(steps=3, log_every=100,
                         data=DataConfig(seq_len=32, global_batch=4))
    log = _trainer(cfg, tcfg).run()
    assert all(np.isfinite(m["loss"]) for m in log)


def test_data_determinism():
    cfg = get_smoke_config("tinyllama-1.1b")
    d1 = SyntheticLMDataset(cfg, DataConfig(seq_len=32, global_batch=4,
                                            seed=7))
    d2 = SyntheticLMDataset(cfg, DataConfig(seq_len=32, global_batch=4,
                                            seed=7))
    b1, b2 = d1.batch(13), d2.batch(13)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = d1.batch(14)
    assert not np.array_equal(b1["tokens"], b3["tokens"])


def test_labels_are_next_tokens():
    cfg = get_smoke_config("tinyllama-1.1b")
    ds = SyntheticLMDataset(cfg, DataConfig(seq_len=32, global_batch=2))
    b = ds.batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_checkpoint_roundtrip():
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones((4,), dtype=torch.bfloat16)}}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 42, tree, extra={"note": "x"})
        assert latest_step(d) == 42
        restored, step, extra = load_checkpoint(d, tree)
        assert step == 42 and extra["note"] == "x"
        np.testing.assert_array_equal(restored["w"].numpy(),
                                      tree["w"].numpy())
        assert restored["nested"]["b"].dtype == tree["nested"]["b"].dtype


def test_checkpoint_shape_mismatch_rejected():
    tree = {"w": torch.ones((2, 3))}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, tree)
        with pytest.raises(ValueError, match="shape"):
            load_checkpoint(d, {"w": torch.ones((3, 2))})


def test_trainer_resume():
    _runtime()
    cfg = get_smoke_config("qwen3-1.7b")
    with tempfile.TemporaryDirectory() as d:
        tcfg = TrainerConfig(steps=4, log_every=100, ckpt_every=2,
                             ckpt_dir=d,
                             data=DataConfig(seq_len=32, global_batch=4))
        tr = _trainer(cfg, tcfg)
        tr.run()
        tr2 = _trainer(cfg, tcfg)
        assert tr2.maybe_restore()
        assert tr2.step_idx == 4
        # the restored state is the saved one, bit for bit
        for a, b in zip(tree_flatten(tr.global_state())[0],
                        tree_flatten(tr2.global_state())[0]):
            assert torch.equal(a, b)


def test_adamw_decoupled_weight_decay():
    p = {"w": torch.ones((4,), dtype=torch.float32)}
    g = {"w": torch.zeros((4,), dtype=torch.float32)}
    st = adamw_init(p)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5, grad_clip=1e9)
    p2, st, _ = adamw_update(p, g, st, cfg)
    # zero grads: only decay applies: w - lr*wd*w = 1 - 0.05
    np.testing.assert_allclose(p2["w"].numpy(), 0.95, rtol=1e-6)


def test_hot_reload_mid_training_rebuilds():
    from repro_torch.policies import bad_channels, static_override
    rt = PolicyRuntime(tier="torch")
    rt.load(static_override.program)
    reset_dispatcher(runtime=rt)
    cfg = get_smoke_config("tinyllama-1.1b")
    tcfg = TrainerConfig(steps=2, log_every=100,
                         data=DataConfig(seq_len=32, global_batch=4))
    tr = _trainer(cfg, tcfg)
    tr.run(steps=2)
    assert tr.rebuilds == 0
    rt.reload(bad_channels.program)      # operator swaps policy live
    tr.run(steps=2)                      # must not raise; rebuilds once
    assert tr.step_idx == 4 and tr.rebuilds == 1


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-large-v3",
                                  "llava-next-mistral-7b"])
def test_batches_bit_equal_the_reference(arch):
    """Dense, audio (``frames``) and VLM (``patches``) batches; also
    through the prefetcher from a start step."""
    dcfg = dict(seq_len=24, global_batch=3, seed=5)
    ref = RefDataset(ref_smoke(arch), RefDataConfig(**dcfg))
    port = SyntheticLMDataset(get_smoke_config(arch), DataConfig(**dcfg))
    pre = make_dataset(get_smoke_config(arch), DataConfig(**dcfg),
                       start_step=2)
    try:
        it = iter(pre)
        for step in range(2, 5):
            want = ref.batch(step)
            for got in (port.batch(step), next(it)):
                assert sorted(got) == sorted(want)
                for k in want:
                    assert got[k].dtype == want[k].dtype
                    np.testing.assert_array_equal(got[k], want[k])
    finally:
        pre.stop()


def test_full_size_batches_bit_equal_the_reference():
    """The training cell's shape: Qwen3-1.7B's 151,936-token vocabulary,
    4 x 2048, at step 0 and a later step (two reference batches, about
    2 s each on a CPU)."""
    dcfg = dict(seq_len=2048, global_batch=4, seed=11)
    ref = RefDataset(ref_config("qwen3-1.7b"), RefDataConfig(**dcfg))
    port = SyntheticLMDataset(get_config("qwen3-1.7b"), DataConfig(**dcfg))
    assert port.cfg.vocab == 151_936
    for step in (0, 7):
        want, got = ref.batch(step), port.batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-large-v3"])
def test_cdf_tables_and_the_generator_after_a_batch(arch, monkeypatch):
    """The tables are legacy ``choice(p=)``'s own, and a batch leaves its
    generator where the reference's leaves it: the modality stubs are
    drawn next.  Batch 2 wide, so many positions draw no reset."""
    dcfg = dict(seq_len=16, global_batch=2, seed=3)
    port = SyntheticLMDataset(get_smoke_config(arch), DataConfig(**dcfg))
    ref = RefDataset(ref_smoke(arch), RefDataConfig(**dcfg))
    for cdf, p in ((port.succ_cdf, port.succ_p),
                   (port.unigram_cdf, port.unigram)):
        assert cdf.dtype == np.float64
        assert cdf[-1] == 1.0
        np.testing.assert_array_equal(cdf, p.cumsum() / p.cumsum()[-1])
    made = []
    real = np.random.RandomState

    def recording(*a):
        made.append(real(*a))
        return made[-1]

    monkeypatch.setattr(np.random, "RandomState", recording)
    after = []
    for ds in (port, ref):
        ds.batch(5)
        rng = made[-1]
        after.append((rng.get_state(), rng.randn(3)))
    np.testing.assert_equal(after[0], after[1])


def test_prefetcher_stops():
    pre = make_dataset(get_smoke_config("tinyllama-1.1b"),
                       DataConfig(seq_len=8, global_batch=2))
    next(iter(pre))
    pre.stop()
    pre._t.join(timeout=10)
    assert not pre._t.is_alive()


@pytest.mark.parametrize("total,warmup", [(30, 5), (10, 0), (100, 100)])
def test_schedule_equals_the_reference(total, warmup):
    steps = np.arange(0, total + 10, dtype=np.int32)
    for s in steps:
        got = cosine_schedule(torch.tensor(s), total, warmup)
        assert got.dtype == torch.float32
        want = np.asarray(ref_cosine(jnp.asarray(s), total, warmup))
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
        w = linear_warmup(torch.tensor(s), warmup)
        assert abs(float(w) - float(ref_warmup(jnp.asarray(s), warmup))) \
            <= 1e-6


def _random_tree(rng):
    return {"a": rng.randn(3, 5).astype(np.float32),
            "b": [rng.randn(7).astype(np.float32),
                  {"c": rng.randn(2, 2, 2).astype(np.float32)}]}


@pytest.mark.parametrize("clip", [1.0, 1e9])
def test_adamw_equals_the_reference(clip):
    """Three updates on random trees (one clipped, one not), with a
    schedule's ``lr_scale``: params, ``m``, ``v``, ``step`` and the
    metrics within 1e-6 relative."""
    rng = np.random.RandomState(3)
    params = _random_tree(rng)
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip=clip)
    p_ref = jax.tree.map(jnp.asarray, params)
    p = tree_map(torch.from_numpy, params)
    st_ref, st = ref_adamw_init(p_ref), adamw_init(p)
    for i in range(3):
        g = jax.tree.map(lambda a: a * (2.0 + i), _random_tree(rng))
        scale = 0.5 + 0.25 * i
        p_ref, st_ref, m_ref = ref_adamw_update(
            p_ref, jax.tree.map(jnp.asarray, g), st_ref,
            RefAdamWConfig(**cfg), jnp.float32(scale))
        p, st, m = adamw_update(p, tree_map(torch.from_numpy, g), st,
                                AdamWConfig(**cfg), torch.tensor(scale))
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 3
    for want, got in ((p_ref, p), (st_ref["m"], st["m"]),
                      (st_ref["v"], st["v"])):
        for a, b in zip(jax.tree.leaves(want), tree_flatten(got)[0]):
            assert rel(b.numpy(), a) <= 1e-6
    for k in ("grad_norm", "lr"):
        assert rel(float(m[k]), float(m_ref[k])) <= 1e-6


def _mixed_tree():
    rng = np.random.RandomState(4)
    return {"w": rng.randn(3, 4).astype(np.float32),
            "nested": {"b": rng.randn(5).astype(np.float32),
                       "i": np.arange(6, dtype=np.int32)},
            "list": [rng.randn(2).astype(np.float32)],
            "step": np.asarray(7, np.int32)}


def test_checkpoint_written_by_the_reference_loads_in_the_port():
    tree = _mixed_tree()
    ref_tree = jax.tree.map(jnp.asarray, tree)
    ref_tree["nested"]["b"] = ref_tree["nested"]["b"].astype(jnp.bfloat16)
    template = tree_map(torch.from_numpy, tree)
    template["nested"]["b"] = template["nested"]["b"].bfloat16()
    with tempfile.TemporaryDirectory() as d:
        ref_save(d, 3, ref_tree, extra={"arch": "x"})
        got, step, extra = load_checkpoint(d, template)
    assert step == 3 and extra == {"arch": "x"}
    assert got["nested"]["b"].dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(ref_tree), tree_flatten(got)[0]):
        want = np.asarray(jnp.asarray(a, jnp.float32))
        np.testing.assert_array_equal(b.float().numpy(), want)


def test_checkpoint_written_by_the_port_loads_in_the_reference():
    tree = _mixed_tree()
    tree["step"] = np.asarray(tree["step"])
    tree = tree_map(torch.from_numpy, tree)
    tree["nested"]["b"] = tree["nested"]["b"].bfloat16()
    template = jax.tree.map(jnp.asarray, _mixed_tree())
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 5, tree, extra={"arch": "y"})
        got, step, extra = ref_load(d, template)
    assert step == 5 and extra == {"arch": "y"}
    assert str(got["nested"]["b"].dtype) == "bfloat16"
    assert got["step"].dtype == np.int32 and int(got["step"]) == 7
    for a, b in zip(jax.tree.leaves(got), tree_flatten(tree)[0]):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())


STEP_ARCHS = ["tinyllama-1.1b", "qwen3-1.7b", "olmoe-1b-7b",
              "recurrentgemma-9b"]
STEP_CFG = dict(total_steps=10, warmup_steps=2)


def _step_batch(cfg):
    rng = np.random.RandomState(11)
    toks = rng.randint(0, cfg.vocab, (2, 17)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_one_f32_train_step_equals_the_reference(arch):
    ref_cfg = ref_smoke(arch).with_overrides(dtype="float32")
    cfg = get_smoke_config(arch).with_overrides(dtype="float32")
    params, specs = R.init_params(jax.random.PRNGKey(0), ref_cfg, REF_AX1)
    start = jax.tree.map(np.asarray, params)
    batch = _step_batch(cfg)

    ref_reset(runtime=RefRuntime())
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    step, _ = ref_make_train_step(ref_cfg, REF_AX1, mesh, specs,
                                  RefStepConfig(**STEP_CFG))
    p_ref, o_ref, m_ref = step(params, ref_adamw_init(params),
                               {k: jnp.asarray(v) for k, v in batch.items()})

    _runtime()
    p = params_from_numpy(start, device="cpu")
    _, port_specs = init_params(0, cfg, AX1, device="cpu")
    pstep, _ = make_train_step(cfg, AX1, None, port_specs,
                               TrainStepConfig(**STEP_CFG))
    p, o, m = pstep(p, adamw_init(p), batch)

    for k in ("loss", "grad_norm", "lr"):
        assert rel(float(m[k]), float(m_ref[k])) <= 1e-5, k
    assert int(o["step"]) == int(o_ref["step"]) == 1
    for name, want, got in (("m", o_ref["m"], o["m"]),
                            ("v", o_ref["v"], o["v"])):
        for a, b in zip(jax.tree.leaves(want), tree_flatten(got)[0]):
            assert b.shape == a.shape
            assert rel(b.numpy(), np.asarray(a)) <= 1e-5, name
    # an element whose clipped gradient is within 100 eps of zero (but
    # not 0: an unused row only decays) moves by g / (|g| + eps), which turns the gradient's own rounding (the
    # residue of a cancellation) into the update's: those elements are
    # held through m and v above, and are at most 1% of a leaf
    adam = AdamWConfig()
    for a, b, mom in zip(jax.tree.leaves(p_ref), tree_flatten(p)[0],
                         jax.tree.leaves(o_ref["m"])):
        a, b = np.asarray(a), b.numpy()
        mom = np.abs(np.asarray(mom))
        sure = (mom >= (1 - adam.b1) * 100 * adam.eps) | (mom == 0)
        assert rel(b[sure], a[sure]) <= 1e-5


def _grads(cfg, params_np, batch):
    p = params_from_numpy(params_np, device="cpu")
    flat, rebuild = tree_flatten(p)
    leaves = [t.requires_grad_() for t in flat]
    loss = loss_fn(rebuild(leaves), {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, cfg, AX1)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-9b"])
def test_remat_variants_give_equal_gradients(arch):
    cfg = get_smoke_config(arch).with_overrides(dtype="float32")
    params, _ = R.init_params(jax.random.PRNGKey(1), ref_smoke(arch),
                              REF_AX1)
    params = jax.tree.map(np.asarray, params)
    batch = _step_batch(cfg)
    _runtime()
    loss0, g0 = _grads(cfg, params, batch)
    for policy in ("none", "save_psum"):
        c = cfg.with_overrides(remat=True, remat_policy=policy)
        loss, g = _grads(c, params, batch)
        assert loss == loss0
        for a, b in zip(g0, g):
            assert rel(b.numpy(), a.numpy()) <= 1e-6, policy


def test_launcher_trains_on_the_cpu(tmp_path):
    from repro_torch.launch.train import main
    log = main(["--smoke", "--steps", "3", "--seq", "16", "--batch", "2",
                "--device", "cpu", "--policy", "size_aware",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"])
    assert len(log) == 3 and all(np.isfinite(m["loss"]) for m in log)
    assert latest_step(str(tmp_path)) == 3
    log = main(["--smoke", "--steps", "3", "--seq", "16", "--batch", "2",
                "--device", "cpu", "--ckpt-dir", str(tmp_path),
                "--ckpt-every", "3"])
    assert log[-1]["step"] == 6          # resumed from step 3


def test_production_mesh_raises_rather_than_shrinking():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(ValueError, match="needs 256 rank"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="needs 512 rank"):
        make_production_mesh(multi_pod=True, device_type="cpu")


def test_train_example_on_the_cpu():
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "train_lm_torch.py")
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    out = ex.main(["--cpu", "--steps", "8", "--d-model", "64", "--layers",
                   "2", "--seq", "16", "--batch", "4", "--vocab", "256"])
    assert out["steps"] == 8 and out["reloads"] == 1
    assert out["rebuilds"] == 1
    assert all(np.isfinite(out["losses"]))
