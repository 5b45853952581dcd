"""Meshes and mesh facts (the port of ``repro/launch/mesh.py``'s
``make_host_mesh`` and ``mesh_topology``).

Works over a ``torch.distributed.device_mesh.DeviceMesh``: reading one
touches no process group; :func:`make_host_mesh` builds one over the
default process group.  ``make_production_mesh`` and ``mesh_axes`` need
the models' ``MeshAxes`` and come with the port of the models.
"""

from __future__ import annotations

import os
from typing import Optional


def make_host_mesh(n: int = 1, device_type: str = "cuda"):
    """Small ``(1, n)`` mesh named ``("data", "model")`` over ranks
    ``0 .. n - 1`` of the default process group (tests/examples).

    Raises ``ValueError`` when the process has fewer than ``n`` ranks, or,
    for ``device_type="cuda"``, fewer than ``n`` cards (NCCL refuses two
    ranks on one card), instead of silently shrinking — a shrunk mesh
    changes every collective's rank count and invalidates sizes and
    bandwidths downstream, far from the cause.
    """
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    ranks = dist.get_world_size() if dist.is_initialized() else 0
    cards = torch.cuda.device_count() if device_type == "cuda" else None
    if ranks < n or (cards is not None and cards < n):
        has = (f"{ranks} rank(s) in its default process group"
               if dist.is_initialized()
               else "no default process group (torch.distributed is not "
                    "initialized)")
        if cards is not None:
            has += f" and {cards} CUDA device(s)"
        raise ValueError(
            f"make_host_mesh(n={n}, device_type={device_type!r}) needs {n} "
            f"rank(s) but this process has {has}; start {n} ranks with "
            f"torchrun --nproc-per-node={n} (one card each), or, on the "
            "host, init_process_group('gloo', world_size=n) in each of n "
            "processes and pass device_type='cpu'")
    return DeviceMesh(device_type, torch.arange(n).reshape(1, n),
                      mesh_dim_names=("data", "model"))


def mesh_topology(mesh, axis_name: Optional[str] = None) -> dict:
    """Topology facts the dispatcher feeds into policy contexts.

    Returns ``{"n_nodes", "ranks_per_node", "n_devices", "axis_sizes"}``.
    torch has no ``Device.process_index``, and every rank is its own
    process, so nodes are counted from the launcher's ranks per node:
    ``LOCAL_WORLD_SIZE`` (as torchrun sets it; consecutive global ranks
    share a node), and a rank's node is ``rank // LOCAL_WORLD_SIZE``.
    Without ``LOCAL_WORLD_SIZE`` every rank of the mesh counts as one
    node's (the single-host case).  ``axis_name`` must name a mesh
    dimension (the axis a collective runs over); ``None`` covers the
    whole mesh, and the facts always describe the whole mesh, as in the
    reference.
    """
    ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
    names = list(mesh.mesh_dim_names or ())
    sizes = dict(zip(names, (int(s) for s in mesh.mesh.shape)))
    if axis_name is not None and axis_name not in sizes:
        raise ValueError(f"mesh has no axis {axis_name!r}; axes: {names}")
    n_devices = len(ranks)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
    per_node = local if local > 0 else max(ranks) + 1
    n_nodes = max(1, len({r // per_node for r in ranks}))
    return {
        "n_nodes": n_nodes,
        "ranks_per_node": max(1, n_devices // n_nodes),
        "n_devices": n_devices,
        "axis_sizes": sizes,
    }
