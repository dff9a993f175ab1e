"""Hardware constants for the supported target platforms and roofline helpers.

A copy of ``repro.hw.specs`` plus :data:`H100`, the card the port runs on.
The TPU chips are *targets* the analytical cost model describes; the H100 is
measured (:class:`repro_torch.core.measured_runner.MeasuredRunner`), and no
code reads its TPU-geometry fields (``mxu_dim``, ``vreg_*``).  Every performance
number in the framework (cost model, roofline terms) is derived from these
constants, so they live in exactly one place.  Named specs are registered as
:class:`repro_torch.targets.Target` entries — resolve them by name through
``repro_torch.targets.get_target`` rather than importing constants directly.

``TPU_V5E`` is the paper-analogue server-class chip every seed experiment
used.  ``TPU_V5E_LITE`` is a constrained edge analogue (the paper's A7x-class
platform): one MXU worth of FLOPs, a narrow LPDDR-like memory system, and a
small VMEM budget that makes many server-tuned schedules structurally
invalid.  ``TPU_V5P`` is the larger pod-scale chip.  ``H100`` is NVIDIA's
H100 SXM 80GB (Hopper, sm_90), with the peaks the port's roofline bounds use.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float        # FLOP/s per chip
    hbm_bandwidth: float          # bytes/s per chip
    hbm_capacity: int             # bytes per chip
    vmem_capacity: int            # bytes per core (usable budget for kernels)
    ici_bandwidth: float          # bytes/s per link
    ici_links: int                # links per chip (2D torus: 4)
    mxu_dim: int = 128            # systolic array native dim
    vreg_sublanes: int = 8        # native sublane count
    vreg_lanes: int = 128         # native lane count
    kernel_launch_overhead_s: float = 2e-6


TPU_V5E = ChipSpec(
    name="tpu-v5e",
    peak_flops_bf16=197e12,       # 197 TFLOP/s bf16 (assignment constant)
    hbm_bandwidth=819e9,          # 819 GB/s (assignment constant)
    hbm_capacity=16 * 1024**3,    # 16 GiB
    vmem_capacity=96 * 1024**2,   # 96 MiB usable of 128 MiB (pipeline margin)
    ici_bandwidth=50e9,           # ~50 GB/s per link (assignment constant)
    ici_links=4,
)

TPU_V5E_LITE = ChipSpec(
    name="tpu-v5e-lite",
    peak_flops_bf16=25e12,        # single-MXU edge part
    hbm_bandwidth=102e9,          # LPDDR-class memory system
    hbm_capacity=4 * 1024**3,     # 4 GiB
    vmem_capacity=8 * 1024**2,    # 8 MiB usable — large server tiles overflow
    ici_bandwidth=10e9,           # single narrow link
    ici_links=1,
    kernel_launch_overhead_s=8e-6,
)

TPU_V5P = ChipSpec(
    name="tpu-v5p",
    peak_flops_bf16=459e12,       # 459 TFLOP/s bf16
    hbm_bandwidth=2765e9,         # 2.77 TB/s HBM2e
    hbm_capacity=95 * 1024**3,    # 95 GiB
    vmem_capacity=112 * 1024**2,  # 112 MiB usable of 128 MiB
    ici_bandwidth=100e9,          # 3D-torus links
    ici_links=6,
)

H100 = ChipSpec(
    name="h100",
    peak_flops_bf16=989e12,       # dense bf16 on the tensor cores (NVIDIA H100 datasheet, SXM)
    hbm_bandwidth=3.35e12,        # HBM3, 3.35 TB/s (H100 datasheet, SXM)
    hbm_capacity=80 * 1024**3,    # 80 GB HBM3 (H100 datasheet, SXM)
    vmem_capacity=227 * 1024,     # shared memory one block can use on sm_90 (CUDA programming
                                  # guide, compute capability 9.0: 227 KB of the SM's 256 KB)
    ici_bandwidth=50e9,           # one NVLink 4 link, both directions (datasheet: 900 GB/s
                                  # over 18 links)
    ici_links=18,                 # NVLink 4 links per GPU (Hopper architecture white paper)
)


def compute_time_s(flops: float, chips: int = 1, spec: ChipSpec = TPU_V5E) -> float:
    return flops / (chips * spec.peak_flops_bf16)


def memory_time_s(bytes_: float, chips: int = 1, spec: ChipSpec = TPU_V5E) -> float:
    return bytes_ / (chips * spec.hbm_bandwidth)


def collective_time_s(bytes_: float, chips: int = 1, spec: ChipSpec = TPU_V5E) -> float:
    # Per the assignment: collective_bytes / (chips * link_bw).
    return bytes_ / (chips * spec.ici_bandwidth)


def dim_efficiency(block: int, native: int) -> float:
    """Fraction of a hardware-native tile that a block of size `block` fills.

    A block of 96 on a native-128 unit wastes 25% of the lanes: eff = 96/128.
    Blocks larger than native are penalized only by their remainder tile.
    """
    if block <= 0:
        return 0.0
    padded = math.ceil(block / native) * native
    return block / padded
