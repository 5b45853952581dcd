"""The port's dense and VLM models against the reference.

Each smoke config's numpy-seeded weights and batch go through the
reference (``repro.models``, JAX on the CPU) and through the port on
``device="cpu"``: f32 forward logits and aux, the f32 loss and every
gradient leaf (``jax.value_and_grad`` against autograd), bf16 logits,
and f32 decode tokens and caches.  Tolerances and their reasons are in
``tests/torch_models_check.py``.
"""

import pytest

import torch_models_check as chk

ARCHS = ["qwen3-1.7b", "tinyllama-1.1b", "qwen2.5-32b", "stablelm-12b",
         "llava-next-mistral-7b"]


@pytest.mark.parametrize("check", chk.CHECKS)
@pytest.mark.parametrize("arch", ARCHS)
def test_against_the_reference(arch, check):
    chk.run_check(check, arch)
