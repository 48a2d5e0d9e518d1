"""Launch: the client mesh and the (groups, clients) mesh of ranks
(:mod:`repro_torch.launch.mesh`), the port of ``repro/launch/mesh.py``'s
``make_client_mesh`` and ``make_group_mesh``."""
from repro_torch.launch.mesh import (  # noqa: F401
    ClientMesh, GroupMesh, LocalWorld, make_client_mesh, make_group_mesh)
