"""``LM``: a parameter tree held as an ``nn.Module``.

The functions of :mod:`repro_torch.models.transformer` take the tree of
dicts and lists of tensors; ``LM`` registers each leaf as a parameter
(under its path, ``blocks.0.attn.wq``), so ``.to(device)``,
``.parameters()``, ``state_dict()`` and autograd work as usual, and
``tree()`` hands the functions the live parameters.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .config import ModelConfig
from .layers import MeshAxes
from .transformer import forward_logits, loss_fn


class _Node(nn.Module):
    """One dict or list of the tree: leaves as parameters, inner nodes as
    submodules."""

    def __init__(self, tree):
        super().__init__()
        self.is_list = isinstance(tree, (list, tuple))
        self.keys = [str(k) for k in (range(len(tree)) if self.is_list
                                      else tree.keys())]
        for k, v in zip(self.keys, tree if self.is_list else tree.values()):
            if isinstance(v, (dict, list, tuple)):
                self.add_module(k, _Node(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self):
        vals = [getattr(self, k) for k in self.keys]
        vals = [v.tree() if isinstance(v, _Node) else v for v in vals]
        return vals if self.is_list else dict(zip(self.keys, vals))


class LM(nn.Module):
    """A model of the zoo: ``cfg``, the mesh axes and the parameter tree
    (from ``init_params`` or ``params_from_numpy``).  ``forward(batch)``
    is ``forward_logits``; ``loss(batch)`` is ``loss_fn``."""

    def __init__(self, cfg: ModelConfig, params,
                 ax: Optional[MeshAxes] = None):
        super().__init__()
        self.cfg = cfg
        self.ax = ax or MeshAxes()
        self.params = _Node(params)

    def tree(self):
        return self.params.tree()

    def forward(self, batch):
        return forward_logits(self.tree(), batch, self.cfg, self.ax)

    def loss(self, batch) -> torch.Tensor:
        return loss_fn(self.tree(), batch, self.cfg, self.ax)
