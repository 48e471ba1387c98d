"""llama-3.2-11B-vision [hf:meta-llama/Llama-3.2-11B-Vision]: a
cross-attention image layer every 5th layer; the vision tower is a stub
that supplies precomputed patch embeddings at vision_dim=1280
(``data.pipeline.VisionStub``)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    pattern=("ad", "ad", "ad", "adx", "ad"), activation="silu",
    vision_dim=1280, n_patches=1601,
    rope_theta=500_000.0,
    tie_embeddings=False,
)
