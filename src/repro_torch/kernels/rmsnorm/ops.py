"""Public fused-rmsnorm op.

The port of ``repro/kernels/rmsnorm/ops.py``.  Backends:
``"cuda"`` (default) the hand-written kernel, raising
:class:`~repro_torch.device.DeviceError` without a CUDA device or on
tensors elsewhere; ``"torch"`` the plain version on the inputs' device;
``"ref"`` the oracle.

Without a residual the residual stream is ``T(f32(x))``, which is x bit
for bit: the ``"cuda"`` backend returns it as x itself (the same
storage, reshaped; a copy only where x was not contiguous), the plain
version as a cast of x (x itself for float32), as the reference
computes it.  So the stream may alias x on every backend: a caller
must not write to it in place (``res += h``), or x changes too; add
out of place (``res = res + h``).
"""

from __future__ import annotations

from .._build import on_card
from .kernel import fused_rmsnorm_cuda, fused_rmsnorm_plain
from .ref import fused_rmsnorm_ref

BACKENDS = ("cuda", "torch", "ref")


def fused_rmsnorm(x, scale, residual=None, *, eps: float = 1e-6,
                  backend: str = "cuda", bt: int = 128):
    """x: (..., D) flattened internally; returns (normed, residual_stream)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "ref":
        return fused_rmsnorm_ref(x, scale, residual, eps=eps)
    shape = x.shape
    D = shape[-1]
    xf = x.reshape(-1, D)
    rf = residual.reshape(-1, D) if residual is not None else None
    bt = min(bt, xf.shape[0])
    if backend == "torch":
        y, res = fused_rmsnorm_plain(xf, scale, rf, eps=eps, bt=bt)
    else:
        on_card("fused_rmsnorm", *[t for t in (x, scale, residual)
                                   if t is not None])
        y, res = fused_rmsnorm_cuda(
            xf.contiguous(), scale,
            rf.contiguous() if rf is not None else None, eps=eps, bt=bt)
    return y.reshape(shape), res.reshape(shape)
