"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553. InternViT frontend is a STUB (input_specs provides precomputed
patch embeddings); this config is the InternLM2 backbone.
[arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    layer_pattern=("G",),
    mlp_kind="swiglu",
    pos="rope",
    vision_tokens=256,   # stub patch embeddings prepended to the sequence
    source="[arXiv:2404.16821; hf]",
)
