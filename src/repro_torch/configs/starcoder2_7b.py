"""starcoder2-7b [dense]: 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152. GQA + RoPE. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    layer_pattern=("G",),
    mlp_kind="gelu",   # starcoder2 uses a plain gelu MLP (4x)
    mlp_bias=True,
    pos="rope",
    source="[arXiv:2402.19173; hf]",
)
