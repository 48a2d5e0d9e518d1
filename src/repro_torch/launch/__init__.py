"""Launch: the client mesh, the (groups, clients) mesh and the production
(data, model) mesh of ranks (:mod:`repro_torch.launch.mesh`), the port of
``repro/launch/mesh.py``; placements (:mod:`~repro_torch.launch.sharding`),
meta-device specs (:mod:`~repro_torch.launch.specs`), the step builders
and the launchers.  The collectives with gradients are
:mod:`repro_torch.parallel`, which the models read too."""
from repro_torch.launch.mesh import (  # noqa: F401
    ClientMesh, GroupMesh, LocalWorld, ProductionMesh, make_client_mesh,
    make_group_mesh, make_host_mesh, make_mesh, make_production_mesh)
