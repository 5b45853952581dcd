"""The port's encoder-decoder audio model (Whisper) against the reference.

Each smoke config's numpy-seeded weights and batch go through the
reference (``repro.models``, JAX on the CPU) and through the port on
``device="cpu"``: f32 forward logits and aux, the f32 loss and every
gradient leaf (``jax.value_and_grad`` against autograd), bf16 logits,
and f32 decode tokens and caches.  Tolerances and their reasons are in
``tests/torch_models_check.py``.
"""

import pytest

import torch_models_check as chk

ARCHS = ["whisper-large-v3"]


@pytest.mark.parametrize("check", chk.CHECKS)
@pytest.mark.parametrize("arch", ARCHS)
def test_against_the_reference(arch, check):
    chk.run_check(check, arch)


# ---------------------------------------------------------------------------
# GELU: jax.nn.gelu is the tanh approximation; F.gelu's default is erf
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.models.mlp import mlp_block as ref_mlp_block  # noqa: E402
from repro_torch.models import mlp  # noqa: E402


def test_gelu_config_takes_the_tanh_form():
    arch = "whisper-large-v3"
    rcfg, pcfg = chk.configs(arch, "float32")
    assert pcfg.mlp == "gelu"
    p_np = jax.tree.map(lambda a: a[0], chk.case(arch)[1]["blocks"][0]["mlp"])
    p_np = {k: np.asarray(v) for k, v in p_np.items()}
    p_np["b_up"] = np.random.RandomState(0).randn(
        *p_np["b_up"].shape).astype(np.float32)      # nonzero biases
    x = np.random.RandomState(1).randn(2, 16, pcfg.d_model).astype(
        np.float32) * 2.0
    want = np.asarray(ref_mlp_block({k: jnp.asarray(v) for k, v in
                                     p_np.items()}, jnp.asarray(x), rcfg,
                                    chk.REF_AX))
    p_t = {k: torch.from_numpy(v) for k, v in p_np.items()}
    got = mlp.mlp_block(p_t, torch.from_numpy(x), pcfg, chk.AX).numpy()
    tol = 1e-4 * chk.rms(want)
    assert np.abs(got - want).max() <= tol

    # the same block with F.gelu's erf form misses the reference by more
    # than that tolerance (measured: 5x)
    h = torch.from_numpy(x) @ p_t["w_up"] + p_t["b_up"]
    erf = (F.gelu(h) @ p_t["w_down"] + p_t["b_down"]).numpy()
    assert np.abs(erf - want).max() > 2 * tol
