"""Mesh facts for the dispatcher (the port of ``repro/launch/mesh.py``'s
``mesh_topology``).

Works over a ``torch.distributed.device_mesh.DeviceMesh``; reading one
touches no process group.  ``make_production_mesh``, ``mesh_axes`` and
``make_host_mesh`` come with the port of the models.
"""

from __future__ import annotations

import os
from typing import Optional


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
