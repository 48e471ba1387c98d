"""h2o-danube-1.8b [arXiv:2401.16818]: llama+mistral mix, GQA kv=8, SWA."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab_size=32000,
    pattern=("ad",), activation="silu",
    sliding_window=4096, rope_theta=10_000.0,
    tie_embeddings=False,
)
