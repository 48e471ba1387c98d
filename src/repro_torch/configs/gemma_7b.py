"""gemma-7b [arXiv:2403.08295]: GeGLU, head_dim=256, large vocab."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
    d_ff=24576, vocab_size=256000, head_dim=256,
    pattern=("ad",), activation="gelu",
    tie_embeddings=True,
)
