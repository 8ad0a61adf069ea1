"""Distribution: logical-axis sharding on DeviceMeshes, the int8
compressed all-reduce, fault tolerance (the health monitor the fleet
simulator drives, the training launcher's straggler timer and failure
drill, elastic re-meshing)."""

from repro_torch.distributed.collectives import (
    compressed_all_reduce,
    dequantize_int8,
    make_compressed_grad_sync,
    quantize_int8,
)
from repro_torch.distributed.fault import (
    HealthMonitor,
    SimulatedFailure,
    StepTimer,
    elastic_mesh,
    largest_mesh_shape,
)
from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    AxisRules,
    Layout,
    constrain,
    distribute_tree,
    placements,
    tree_placements,
    use_rules,
)

__all__ = [
    "AxisRules",
    "DEFAULT_RULES",
    "HealthMonitor",
    "Layout",
    "SimulatedFailure",
    "StepTimer",
    "compressed_all_reduce",
    "constrain",
    "dequantize_int8",
    "distribute_tree",
    "elastic_mesh",
    "largest_mesh_shape",
    "make_compressed_grad_sync",
    "placements",
    "quantize_int8",
    "tree_placements",
    "use_rules",
]
