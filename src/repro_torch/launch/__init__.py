"""Launchers of the port: meshes, the mesh facts the dispatcher reads, and
the training driver (``python -m repro_torch.launch.train``)."""

from .mesh import (make_host_mesh, make_production_mesh, mesh_axes,
                   mesh_topology)

__all__ = ["make_host_mesh", "make_production_mesh", "mesh_axes",
           "mesh_topology"]
