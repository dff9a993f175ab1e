from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ArchConfig,
    ShapeConfig,
    all_archs,
    all_cells,
    get_arch,
    get_shape,
    reduced,
    shape_applicable,
)

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ArchConfig",
    "ShapeConfig",
    "all_archs",
    "all_cells",
    "get_arch",
    "get_shape",
    "reduced",
    "shape_applicable",
]
