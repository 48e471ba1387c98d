"""xLSTM-1.3b [arXiv:2405.04517, unverified]: mLSTM/sLSTM 7:1, 4 heads,
no separate FFN (d_ff=0; blocks carry pf=2 up/down projections)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    pattern=("xs", "xm", "xm", "xm", "xm", "xm", "xm", "xm"),
    activation="gelu", xlstm_proj_factor=2.0,
    tie_embeddings=True,
)
