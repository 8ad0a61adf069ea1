"""Distribution: fault tolerance (the health monitor the fleet simulator
drives). Sharding, collectives and elastic re-meshing are not ported yet."""

from repro_torch.distributed.fault import HealthMonitor

__all__ = ["HealthMonitor"]
