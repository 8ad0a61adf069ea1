"""Distribution: fault tolerance (the health monitor the fleet simulator
drives, the training launcher's straggler timer and failure drill, the mesh
shape a restart would take). Sharding, collectives and elastic re-meshing
are not ported yet."""

from repro_torch.distributed.fault import (
    HealthMonitor,
    SimulatedFailure,
    StepTimer,
    largest_mesh_shape,
)

__all__ = ["HealthMonitor", "SimulatedFailure", "StepTimer", "largest_mesh_shape"]
