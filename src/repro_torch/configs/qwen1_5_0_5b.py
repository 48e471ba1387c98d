"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B]: QKV bias, 151936 vocab."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab_size=151936,
    pattern=("ad",), activation="silu", qkv_bias=True,
    tie_embeddings=True,
)
