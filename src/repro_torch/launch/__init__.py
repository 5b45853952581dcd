"""Launch helpers of the port: host meshes and the mesh facts the
dispatcher reads."""

from .mesh import make_host_mesh, mesh_topology

__all__ = ["make_host_mesh", "mesh_topology"]
