"""whisper-medium [audio]: 24L d_model=1024 16H (kv=16, MHA) d_ff=4096
vocab=51865. Encoder-decoder; conv frontend is a STUB (input_specs provides
precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,          # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    layer_pattern=("G",),
    mlp_kind="gelu",
    mlp_bias=True,
    pos="learned",
    encoder_layers=24,
    encoder_seq=1500,     # stub: precomputed mel-frame embeddings
    source="[arXiv:2212.04356; unverified]",
)
