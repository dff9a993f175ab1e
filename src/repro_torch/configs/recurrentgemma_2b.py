"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1, MQA)
d_ff=7680 vocab=256000. RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    window=2048,
    layer_pattern=("R", "R", "L"),  # griffin: 2 recurrent then local attn
    mlp_kind="geglu",
    pos="rope",
    rnn_width=2560,
    conv_width=4,
    tie_embeddings=True,
    source="[arXiv:2402.19427; hf]",
)
