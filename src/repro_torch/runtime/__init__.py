from repro_torch.runtime.fault_tolerance import (CheckpointManager,
                                                 StragglerMonitor,
                                                 run_with_restarts)

__all__ = ["CheckpointManager", "StragglerMonitor", "run_with_restarts"]
