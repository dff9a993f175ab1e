from repro_torch.optim.adamw import AdamWConfig, apply_updates, global_norm, init_state, lr_at
from repro_torch.optim.compression import (
    compress_with_feedback,
    compressed_gradients,
    dequantize,
    init_residuals,
    quantize,
)

__all__ = [
    "AdamWConfig",
    "apply_updates",
    "compress_with_feedback",
    "compressed_gradients",
    "dequantize",
    "global_norm",
    "init_residuals",
    "init_state",
    "lr_at",
    "quantize",
]
