"""The port's configs equal the reference's: every ``CONFIG`` and
``SMOKE`` field by field, the ``SHAPES``, ``serving_config``,
``shape_supported``, and the derived numbers (``param_count``,
``block_kinds``, ``padded_*``, ``hd``)."""

import dataclasses
import importlib

import pytest
import torch

import repro.configs as ref
import repro_torch.configs as port

SHAPES = sorted(ref.SHAPES)


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_same_archs_and_shapes():
    assert port.ARCH_IDS == ref.ARCH_IDS
    assert sorted(port.all_archs()) == sorted(ref.all_archs())
    assert {k: dataclasses.asdict(v) for k, v in port.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref.SHAPES.items()}


@pytest.mark.parametrize("arch", ref.ARCH_IDS)
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_config_equals_the_reference_field_by_field(arch, which):
    mod = ref.registry._MODULES[arch]
    a = getattr(importlib.import_module(f"repro_torch.configs.{mod}"), which)
    b = getattr(importlib.import_module(f"repro.configs.{mod}"), which)
    assert _fields(a) == _fields(b)
    assert a == (port.get_config(arch) if which == "CONFIG"
                 else port.get_smoke_config(arch))


@pytest.mark.parametrize("arch", ref.ARCH_IDS)
def test_derived_numbers_equal_the_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        a, b = getattr(port, get)(arch), getattr(ref, get)(arch)
        assert a.param_count() == b.param_count()
        assert a.param_count(active_only=True) == \
            b.param_count(active_only=True)
        assert a.block_kinds() == b.block_kinds()
        assert (a.hd, a.is_moe) == (b.hd, b.is_moe)
        for tp in (1, 2, 4, 8):
            assert a.padded_heads(tp) == b.padded_heads(tp)
            assert a.padded_vocab(tp) == b.padded_vocab(tp)
        assert _fields(a.with_overrides(dtype="float32", n_layers=3)) == \
            _fields(b.with_overrides(dtype="float32", n_layers=3))
        assert a.torch_dtype == {"bfloat16": torch.bfloat16,
                                 "float32": torch.float32}[a.dtype]


@pytest.mark.parametrize("arch", ref.ARCH_IDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_serving_config_and_support_equal_the_reference(arch, shape):
    assert _fields(port.serving_config(arch, shape)) == \
        _fields(ref.serving_config(arch, shape))
    assert port.shape_supported(arch, shape) == \
        ref.shape_supported(arch, shape)


def test_unknown_arch_raises_like_the_reference():
    with pytest.raises(KeyError, match="unknown arch"):
        port.get_config("gpt-2")


def test_port_only_arch_resolves_outside_the_reference_pool():
    """moonlight-16b-a3b, the port's own, resolves by name; the pool the
    reference shares stays the reference's."""
    assert port.ARCH_IDS == ref.ARCH_IDS
    assert "moonlight-16b-a3b" not in port.all_archs()
    cfg = port.get_config("moonlight-16b-a3b")
    assert (cfg.n_layers, cfg.first_k_dense, cfg.n_experts, cfg.top_k,
            cfg.kv_lora_rank, cfg.held_experts) == (27, 1, 64, 6, 512,
                                                    (0, 64))
    smoke = port.get_smoke_config("moonlight-16b-a3b")
    assert smoke.held_experts == (0, 4) and smoke.router == "sigmoid"
    # the reference's configs keep no field of the DeepSeek-V3 block
    assert "kv_lora_rank" not in _fields(port.get_config("olmoe-1b-7b"))
