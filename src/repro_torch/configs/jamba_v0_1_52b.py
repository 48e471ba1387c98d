"""jamba-v0.1 [arXiv:2403.19887]: Mamba+attention 1:7, MoE 16e top-2 every
other layer. Period-8 super-block: attention at offset 4, MoE at odd offsets."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    pattern=("md", "me", "md", "me", "ad", "me", "md", "me"),
    activation="silu",
    n_experts=16, top_k=2, moe_d_ff=14336,
    mamba_d_state=16, mamba_expand=2, mamba_d_conv=4,
    tie_embeddings=False,
)
