"""Launch helpers of the port: the mesh facts the dispatcher reads."""

from .mesh import mesh_topology

__all__ = ["mesh_topology"]
