"""Meshes and mesh facts (the port of ``repro/launch/mesh.py``).

Works over a ``torch.distributed.device_mesh.DeviceMesh``:
:func:`make_production_mesh` and :func:`make_host_mesh` build one over
the default process group, :func:`mesh_axes` reads the models'
``MeshAxes`` (with each axis's process group) from one, and
:func:`mesh_topology` reads the facts the dispatcher feeds into policy
contexts.  Defined as functions, never module-level constants, so
importing this module touches no process group.
"""

from __future__ import annotations

import os
from typing import Optional


def _too_few(what: str, n: int, device_type: str) -> None:
    """Raise ``ValueError`` unless the default process group has ``n``
    ranks and, for ``device_type="cuda"``, the host ``n`` cards."""
    import torch
    import torch.distributed as dist

    ranks = dist.get_world_size() if dist.is_initialized() else 0
    cards = torch.cuda.device_count() if device_type == "cuda" else None
    if ranks >= n and (cards is None or cards >= n):
        return
    has = (f"{ranks} rank(s) in its default process group"
           if dist.is_initialized()
           else "no default process group (torch.distributed is not "
                "initialized)")
    if cards is not None:
        has += f" and {cards} CUDA device(s)"
    raise ValueError(
        f"{what} needs {n} rank(s) but this process has {has}; start {n} "
        f"ranks with torchrun --nproc-per-node={n} (one card each), or, "
        f"on the host, init_process_group('gloo', world_size={n}) in each "
        f"of {n} processes and pass device_type='cpu'")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production mesh: ``(16, 16)`` named ``("data",
    "model")``, or ``(2, 16, 16)`` with a leading ``"pod"`` axis, over
    ranks ``0 .. 255`` (``511``) of the default process group.  Raises
    ``ValueError`` naming the rank count when the group is smaller; the
    mesh is never shrunk (see :func:`make_host_mesh`)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    _too_few(f"make_production_mesh(multi_pod={multi_pod})", n, device_type)
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def mesh_axes(mesh, *, fsdp: bool = True, gather_bf16: bool = False):
    """The ``MeshAxes`` descriptor of a mesh: axis sizes, and the process
    group of each axis longer than 1 (``DeviceMesh.get_group``)."""
    from ..models.layers import MeshAxes

    names = list(mesh.mesh_dim_names or ())
    sizes = dict(zip(names, (int(s) for s in mesh.mesh.shape)))

    def group(name):
        return mesh.get_group(name) if sizes.get(name, 1) > 1 else None

    return MeshAxes(
        data="data", model="model",
        pod="pod" if "pod" in names else None,
        fsdp=fsdp, gather_bf16=gather_bf16,
        tp=sizes.get("model", 1),
        dp=sizes.get("data", 1),
        n_pods=sizes.get("pod", 1),
        model_group=group("model"), data_group=group("data"),
        pod_group=group("pod"),
    )


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
    from torch.distributed.device_mesh import DeviceMesh

    _too_few(f"make_host_mesh(n={n}, device_type={device_type!r})", n,
             device_type)
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
