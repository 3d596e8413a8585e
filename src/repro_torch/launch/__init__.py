"""Launch helpers (the reference's ``launch`` package): device meshes over
``torch.distributed``."""
from .mesh import Mesh, make_mesh, make_production_mesh

__all__ = ["Mesh", "make_mesh", "make_production_mesh"]
