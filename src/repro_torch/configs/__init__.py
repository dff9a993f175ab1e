from repro_torch.configs.base import ARCH_IDS, ArchConfig, get_arch, reduced

__all__ = ["ARCH_IDS", "ArchConfig", "get_arch", "reduced"]
