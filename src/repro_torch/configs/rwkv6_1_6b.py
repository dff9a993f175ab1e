"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168 vocab=65536.
Finch: data-dependent decay. [arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,        # wkv heads: d_model / head_dim
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    layer_pattern=("R",),
    mlp_kind="gelu",   # channel-mix uses squared-relu; see models/recurrent.py
    pos="none",
    source="[arXiv:2404.05892; unverified]",
)
