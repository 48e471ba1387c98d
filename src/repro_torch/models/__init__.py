from repro_torch.models.config import ModelConfig
from repro_torch.models import model as model_lib

__all__ = ["ModelConfig", "model_lib"]
