"""granite-3.0-1b-a400m [hf:ibm-granite]: 32 experts top-8, GQA kv=8."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab_size=49155,
    pattern=("ae",), activation="silu",
    n_experts=32, top_k=8, moe_d_ff=512,
    tie_embeddings=True,
)
