from repro_torch.hw.specs import (
    H100,
    TPU_V5E,
    TPU_V5E_LITE,
    TPU_V5P,
    ChipSpec,
    collective_time_s,
    compute_time_s,
    dim_efficiency,
    memory_time_s,
)

__all__ = [
    "H100",
    "TPU_V5E",
    "TPU_V5E_LITE",
    "TPU_V5P",
    "ChipSpec",
    "collective_time_s",
    "compute_time_s",
    "dim_efficiency",
    "memory_time_s",
]
