"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
Alternating local/global attention, logit softcapping. [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    window=4096,
    layer_pattern=("L", "G"),   # local(4096) / global alternating
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_kind="geglu",
    pos="rope",
    tie_embeddings=True,
    source="[arXiv:2408.00118; hf]",
)
