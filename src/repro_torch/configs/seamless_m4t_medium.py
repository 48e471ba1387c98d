"""seamless-m4t-medium [arXiv:2308.11596]: encoder-decoder; the speech
frontend is a stub that supplies precomputed frame embeddings
(``data.pipeline.AudioStub``).  12 encoder + 12 decoder layers at
d_model=1024 (the "medium" text stack)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206,
    pattern=("adx",), activation="relu",
    n_encoder_layers=12, audio_frames_div=4,
    tie_embeddings=True,
)
