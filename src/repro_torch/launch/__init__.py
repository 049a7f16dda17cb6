"""Launch tooling of the port: client meshes over ``torch.distributed``."""
from .mesh import (
    ClientMesh, collective_tiers, make_client_mesh, mesh_info, run_local_mesh,
)
