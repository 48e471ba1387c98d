"""granite-20b code model [arXiv:2405.04324]: llama-arch, MQA (kv=1)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152,
    pattern=("ad",), activation="gelu", gated_mlp=False,
    tie_embeddings=False,
)
