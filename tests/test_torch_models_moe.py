"""The port's MoE models against the reference.

Each smoke config's numpy-seeded weights and batch go through the
reference (``repro.models``, JAX on the CPU) and through the port on
``device="cpu"``: f32 forward logits and aux, the f32 loss and every
gradient leaf (``jax.value_and_grad`` against autograd), bf16 logits,
and f32 decode tokens and caches.  Tolerances and their reasons are in
``tests/torch_models_check.py``.
"""

import pytest

import torch_models_check as chk

ARCHS = ["olmoe-1b-7b", "llama4-scout-17b-a16e"]


@pytest.mark.parametrize("check", chk.CHECKS)
@pytest.mark.parametrize("arch", ARCHS)
def test_against_the_reference(arch, check):
    chk.run_check(check, arch)


# ---------------------------------------------------------------------------
# router ties: lax.top_k picks the lowest index among equal probabilities
# ---------------------------------------------------------------------------

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.models.moe import router_topk as ref_router_topk  # noqa: E402
from repro_torch.models.moe import router_topk  # noqa: E402


@pytest.mark.parametrize("k", [1, 2, 3])
def test_router_ties_pick_the_experts_lax_top_k_picks(k):
    rng = np.random.RandomState(k)
    # bf16-like logits: a few distinct values, so most rows tie
    logits = rng.randint(-2, 3, (64, 8)).astype(np.float32) * 0.25
    logits[0] = 0.0                         # a row where every expert ties
    logits[1] = [1, 1, 0, 1, 0, 1, 1, 0]    # ties at the top, out of order
    gates_j, idx_j, probs_j = ref_router_topk(jnp.asarray(logits), k)
    gates_t, idx_t, probs_t = router_topk(torch.from_numpy(logits), k)
    assert np.array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(gates_t.numpy(), np.asarray(gates_j),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j),
                               rtol=1e-6, atol=1e-7)
    # the plain torch.topk would be no proof: its order among ties is
    # unspecified, and on such rows it may differ
    assert idx_t[0].tolist() == list(range(k))
