from repro_torch.runtime.fault_tolerance import (CheckpointManager,
                                                 ElasticMesh,
                                                 StragglerMonitor,
                                                 run_with_restarts)

__all__ = ["CheckpointManager", "ElasticMesh", "StragglerMonitor",
           "run_with_restarts"]
