"""The port's serving engine: the cases of ``tests/test_serve.py`` on
``device="cpu"``, the port's engine against the reference's on the same
f32 weights, and ``chip_smoke.py``'s phase-12 helpers at the smoke size.
"""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import init_params as ref_init_params
from repro.models.layers import MeshAxes as RefAxes
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.device import DeviceError, have_cuda
from repro_torch.models import forward_logits, init_params
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import MeshAxes
from repro_torch.serve import (EngineStallError, ServeConfig, ServeEngine)

ROOT = Path(__file__).resolve().parents[1]
AX = MeshAxes(tp=1, dp=1, fsdp=False)


@pytest.fixture(scope="module")
def engine_setup():
    cfg = get_smoke_config("tinyllama-1.1b")
    params, _ = init_params(0, cfg, AX, device="cpu")
    return cfg, params


def _engine(setup, slots):
    cfg, params = setup
    return ServeEngine(cfg, params, AX,
                       ServeConfig(batch_slots=slots, max_ctx=64),
                       device="cpu")


def test_batched_requests_complete(engine_setup):
    eng = _engine(engine_setup, 3)
    reqs = [eng.submit([1, 2, 3, 4], max_new=5) for _ in range(7)]
    steps = eng.run_until_drained()
    assert all(r.done for r in reqs)
    assert all(len(r.out) == 5 for r in reqs)
    # continuous batching actually overlapped: fewer steps than serial
    assert steps < 7 * (4 + 5)


def test_deterministic_same_prompt(engine_setup):
    outs = []
    for _ in range(2):
        eng = _engine(engine_setup, 2)
        r = eng.submit([5, 6, 7], max_new=6)
        eng.run_until_drained()
        outs.append(r.out)
    assert outs[0] == outs[1]


def test_slot_isolation(engine_setup):
    """A request decoded alongside others matches one decoded alone."""
    eng1 = _engine(engine_setup, 1)
    alone = eng1.submit([9, 8, 7, 6], max_new=4)
    eng1.run_until_drained()

    eng2 = _engine(engine_setup, 3)
    together = eng2.submit([9, 8, 7, 6], max_new=4)
    eng2.submit([1, 1, 1], max_new=8)
    eng2.submit([2, 3, 2, 3, 2], max_new=8)
    eng2.run_until_drained()
    assert alone.out == together.out


def test_stall_raises_with_active_request_ids(engine_setup):
    eng = _engine(engine_setup, 1)
    r1 = eng.submit([1, 2, 3], max_new=8)
    r2 = eng.submit([4, 5], max_new=8)
    with pytest.raises(EngineStallError) as ei:
        eng.run_until_drained(max_steps=3)
    assert ei.value.steps == 3
    assert r1.rid in ei.value.active_rids
    assert r2.rid in ei.value.queued_rids
    assert str(r1.rid) in str(ei.value)
    # the silent behaviour stays available, and the engine is usable
    # after a stall: draining to completion still works
    assert eng.run_until_drained(max_steps=4, on_stall="return") == 4
    eng.run_until_drained()
    assert r1.done and r2.done


def test_decode_matches_full_forward(engine_setup):
    """Greedy decode via the cache == argmax of the full forward pass."""
    cfg, params = engine_setup
    prompt = [3, 1, 4, 1, 5]
    eng = _engine(engine_setup, 1)
    r = eng.submit(prompt, max_new=1)
    eng.run_until_drained()
    with torch.no_grad():
        logits, _ = forward_logits(
            params, {"tokens": torch.tensor([prompt], dtype=torch.int32)},
            cfg, AX)
    assert r.out[0] == int(torch.argmax(logits[0, -1]))


def test_engine_runs_on_the_card_unless_asked(engine_setup):
    cfg, params = engine_setup
    if have_cuda():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(DeviceError):
        ServeEngine(cfg, params, AX, ServeConfig(batch_slots=1, max_ctx=8))


def test_engine_casts_weights_once_to_the_config_dtype(engine_setup):
    cfg, params = engine_setup
    eng = _engine(engine_setup, 1)
    assert cfg.dtype == "bfloat16"
    assert eng.params["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert eng.params["embed"].dtype == torch.bfloat16
    assert params["embed"].dtype == torch.float32       # the caller's own


def test_same_tokens_as_the_reference_engine():
    """The same f32 tinyllama smoke weights and 7 requests over 3 slots
    through both engines give the same tokens."""
    rcfg = ref_smoke("tinyllama-1.1b").with_overrides(dtype="float32")
    pcfg = get_smoke_config("tinyllama-1.1b").with_overrides(dtype="float32")
    rax = RefAxes(tp=1, dp=1, fsdp=False)
    pj, _ = ref_init_params(jax.random.PRNGKey(0), rcfg, rax)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, rcfg.vocab, rng.randint(2, 7)).tolist()
               for _ in range(7)]
    ref = RefServeEngine(rcfg, pj, rax, RefServeConfig(batch_slots=3,
                                                       max_ctx=64))
    port = ServeEngine(pcfg, pt, AX, ServeConfig(batch_slots=3, max_ctx=64),
                       device="cpu")
    rr = [ref.submit(p, max_new=6) for p in prompts]
    rp = [port.submit(p, max_new=6) for p in prompts]
    assert ref.run_until_drained() == port.run_until_drained()
    assert [r.out for r in rp] == [r.out for r in rr]


# ---------------------------------------------------------------------------
# chip_smoke.py phase 12 at the smoke size, on the CPU (tier torch beside
# interp), so that a fault of its logic shows before the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_phase12", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def phase12(smoke):
    cfg = get_smoke_config(smoke.SERVE_ARCH)
    params, _ = init_params(12, cfg, smoke.serve_axes(), device="cpu")
    run = smoke.serve_with_loop(cfg, params, "cpu", "torch", slots=4,
                                ctx=64, n_requests=6, max_new=5,
                                prompt_lens=(3, 8))
    return cfg, params, run


def test_phase12_serving_loop_equals_its_interp_replay(smoke, phase12):
    cfg, _, run = phase12
    replay = smoke.replay_loop(run["lat_ns"])
    counts = smoke.check_serving(run, replay, cfg.vocab, 5)
    assert counts["tokens"] == 6 * 5
    assert counts["ticks"] == len(run["lat_ns"]) < counts["serial"]
    assert {n: s["calls"] for n, s in run["stats"].items()} == \
        {"adapt_profiler": counts["ticks"], "adapt_tuner": 1}
    assert all(s["host_fallbacks"] == 0 for s in run["stats"].values())
    assert run["warm_uploads"] == 0
    # a stream fed differently gives other map bytes: the check can fail
    other = smoke.replay_loop(run["lat_ns"][:-1])
    assert other["adapt_map"] != run["adapt_map"]


def test_phase12_decode_against_forward_holds(smoke, phase12):
    cfg, _, run = phase12
    out = smoke.decode_against_forward(cfg, run["engine"].params, "cpu",
                                       n_tokens=16, ctx=64)
    assert out["err_over_limit"] <= 1.0
    assert out["tokens_equal"] >= out["sure_positions"]
    floor = smoke.bf16_floor(cfg, phase12[1], run["engine"].params, "cpu",
                             n_tokens=16)
    assert 0 < floor["rms_over_rms"] < smoke.DECODE_RMS_LIMIT


def test_phase12_decode_limit_fails_a_cache_that_is_not_written(
        smoke, phase12, monkeypatch):
    from repro_torch.models import attention
    cfg, _, run = phase12
    orig = attention.attention_decode

    def forgetful(p, x, cache, *a, **kw):
        y, _ = orig(p, x, cache, *a, **kw)
        return y, cache
    monkeypatch.setattr(attention, "attention_decode", forgetful)
    with pytest.raises(RuntimeError, match="decode off forward"):
        smoke.decode_against_forward(cfg, run["engine"].params, "cpu",
                                     n_tokens=16, ctx=64)



@pytest.mark.parametrize("arch", ["qwen3-1.7b", "xlstm-1.3b",
                                  "recurrentgemma-9b", "whisper-large-v3",
                                  "olmoe-1b-7b", "llava-next-mistral-7b"])
def test_weights_cast_once_give_the_same_bits(arch):
    """``compute_params`` casts what every use casts anyway: the bf16
    forward on the cast tree equals the one on the f32 tree bit for bit,
    and the leaves the reference reads in f32 stay f32."""
    from repro_torch.models.convert import F32_LEAVES, compute_params
    cfg = get_smoke_config(arch)
    params, _ = init_params(5, cfg, AX, device="cpu")
    cast = compute_params(params, cfg)
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 8), generator=g)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn(2, cfg.n_audio_frames, cfg.d_model,
                                      generator=g)
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(2, cfg.n_patch_tokens, cfg.d_model,
                                       generator=g)
    with torch.no_grad():
        want, _ = forward_logits(params, batch, cfg, AX)
        got, _ = forward_logits(cast, batch, cfg, AX)
    assert torch.equal(got, want)
    for block in cast["blocks"]:
        for owner, names in F32_LEAVES.items():
            for n in names & set(block.get(owner, {})):
                assert block[owner][n].dtype == torch.float32
    assert cast["embed"].dtype == torch.bfloat16


def test_serve_adaptive_example_runs_on_the_cpu():
    """``examples/serve_adaptive_torch.py``'s ``main`` on the CPU with the
    policies' plain version: every request served, one profiler sample
    per engine tick, the tuner's decision from the policy."""
    spec = importlib.util.spec_from_file_location(
        "serve_adaptive_torch_example",
        ROOT / "examples" / "serve_adaptive_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(device="cpu", tier="torch")
    assert out["served"] == out["requests"] == 16
    assert out["samples"] == out["ticks"] > 0
    assert out["decision"].from_policy
