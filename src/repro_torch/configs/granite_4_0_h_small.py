"""granite-4.0-h-small [hf:ibm-granite/granite-4.0-h-small, config.json]:
32B-A9B, 40 layers of a 10-layer period (Mamba-2 mixers, attention at
offset 5), every layer with 72 experts top 10 (768) beside a shared expert
(1536); Mamba-2 128 heads of 64, d_state 128, one group, conv 4 with a
bias; GQA 32/8 with NoPE; muP multipliers (embedding 12, residual 0.22,
attention 1/128, logits / 16); vocab 100,352, tied embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-4.0-h-small", family="hybrid",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=768, vocab_size=100352,
    pattern=("ms", "ms", "ms", "ms", "ms", "as", "ms", "ms", "ms", "ms"),
    activation="silu", norm_eps=1e-5,
    n_experts=72, top_k=10, moe_d_ff=768, shared_d_ff=1536,
    mamba_d_state=128, mamba_expand=2, mamba_d_conv=4,
    mamba_n_heads=128,
    embedding_multiplier=12.0, residual_multiplier=0.22,
    attention_multiplier=0.0078125, logits_scaling=16.0, use_rope=False,
    tie_embeddings=True,
)
