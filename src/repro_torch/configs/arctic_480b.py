"""snowflake-arctic-base [hf:Snowflake]: 128 experts top-2 + dense residual."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    pattern=("ar",), activation="silu",
    n_experts=128, top_k=2, moe_d_ff=4864,
    tie_embeddings=False,
)
