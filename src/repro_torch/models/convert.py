"""Weights carried across, and weights cast once for serving.

``params_from_numpy`` takes a parameter tree as numpy arrays (for
example the reference's ``init_params`` tree after ``np.asarray`` on each
leaf) and returns the port's tree: the same keys, stacked shapes and
dtypes, so both packages compute on the same weights.

``compute_params`` casts to the config's dtype once the leaves that every
use casts to the activation dtype anyway (the linears, embeddings, norm
scales and biases): ``w.to(x.dtype)`` at each call then does nothing, and
the bits are the same as the per-call cast's.  The leaves the reference
reads in f32 stay f32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .config import ModelConfig
from .transformer import tree_map

# leaves read in f32 whatever the activation dtype, by the block that
# owns them (recurrent.py: the mLSTM gate projections, the sLSTM
# recurrent weights, the RG-LRU conv and decay)
F32_LEAVES = {"mlstm": {"w_i", "w_f", "b_i", "b_f"},
              "slstm": {"r_z", "r_i", "r_f", "r_o"},
              "rglru": {"conv_w", "conv_b", "lam"}}


def params_from_numpy(tree, device=None):
    """The port's parameter tree from a tree of numpy arrays (dicts,
    lists and tuples as in the reference), on the card unless ``device``
    names another."""
    dev = resolve_device(device, "params_from_numpy")
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)


def compute_params(params, cfg: ModelConfig):
    """``params`` with every leaf that each use casts to the activation
    dtype cast once to ``cfg``'s dtype (see the module docstring)."""
    dt = cfg.torch_dtype

    def walk(tree, owner):
        if isinstance(tree, list):
            return [walk(v, owner) for v in tree]
        return {k: walk(v, k) if isinstance(v, (dict, list)) else
                (v if k in F32_LEAVES.get(owner, ()) else v.to(dt))
                for k, v in tree.items()}

    return walk(params, None)
