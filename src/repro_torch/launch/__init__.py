"""Launch: the client mesh of ranks (:mod:`repro_torch.launch.mesh`), the
port of ``repro/launch/mesh.py``'s ``make_client_mesh``."""
from repro_torch.launch.mesh import (  # noqa: F401
    ClientMesh, LocalWorld, make_client_mesh, make_group_mesh)
