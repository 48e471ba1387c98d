from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                     cosine_schedule, global_norm, init_state)

__all__ = ["AdamWConfig", "apply_updates", "cosine_schedule", "global_norm",
           "init_state"]
