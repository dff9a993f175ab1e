"""Kernel workloads and kernel classes (paper §4.2).

A copy of ``repro.core.workload``'s class registry and :class:`KernelInstance`
(the port imports nothing of ``repro``).  The JSON blob hashed by
:meth:`KernelInstance.workload_key` is byte-identical to the reference's, so a
kernel instance has the same workload key in both packages — the key every
schedule database, registry and plan is indexed by.

A *kernel class* is the set of kernels sharing the same operator sequence
regardless of tensor shapes — the unit within which auto-schedules are
transferable.  A *workload key* hashes class + shapes + dtype.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
MATMUL_AXES = ("M", "N", "K")
ATTENTION_AXES = ("Q", "KV")
SCAN_AXES = ("T", "C")

#: class_id -> (axes, family).  Schedules never transfer across class_ids;
#: the family names the kernel template.
KERNEL_CLASSES: dict[str, tuple[tuple[str, ...], str]] = {
    # --- matmul family: projection GEMMs with fused epilogues -------------
    "matmul": (MATMUL_AXES, "matmul"),
    "matmul_bias": (MATMUL_AXES, "matmul"),
    "matmul_bias_gelu": (MATMUL_AXES, "matmul"),
    "matmul_silu_glu": (MATMUL_AXES, "matmul"),        # fused gate*up SwiGLU
    "matmul_gelu_glu": (MATMUL_AXES, "matmul"),        # GeGLU variant
    "matmul_residual": (MATMUL_AXES, "matmul"),        # out-proj + residual add
    "matmul_lmhead": (MATMUL_AXES, "matmul"),          # hidden -> vocab
    "matmul_lmhead_softcap": (MATMUL_AXES, "matmul"),  # gemma2 final softcap
    "moe_gemm_silu_glu": (MATMUL_AXES + ("E",), "matmul"),  # grouped expert up-GEMM
    "moe_gemm": (MATMUL_AXES + ("E",), "matmul"),      # grouped expert down-GEMM
    "moe_router": (MATMUL_AXES, "matmul"),             # hidden -> n_experts
    # --- attention family --------------------------------------------------
    "flash_attention_causal": (ATTENTION_AXES, "attention"),
    "flash_attention_swa": (ATTENTION_AXES, "attention"),        # sliding window
    "flash_attention_local": (ATTENTION_AXES, "attention"),      # gemma2 local
    "flash_attention_softcap": (ATTENTION_AXES, "attention"),    # gemma2 global
    "flash_attention_bidir": (ATTENTION_AXES, "attention"),      # encoder
    "flash_attention_cross": (ATTENTION_AXES, "attention"),      # enc-dec cross
    # --- recurrent-scan family ---------------------------------------------
    "rwkv6_scan": (SCAN_AXES, "scan"),
    "rglru_scan": (SCAN_AXES, "scan"),
    # --- CNN classes (implicit GEMM) ----------------------------------------
    "conv2d_add": (MATMUL_AXES, "matmul"),
    "conv2d_bias_relu": (MATMUL_AXES, "matmul"),
    "conv2d_bias_add_relu": (MATMUL_AXES, "matmul"),
    "dense_add": (MATMUL_AXES, "matmul"),
    "max_pool2d": (("M", "N", "K"), "matmul"),
    "global_avg_pool2d": (("M", "N", "K"), "matmul"),
}


def class_axes(class_id: str) -> tuple[str, ...]:
    return KERNEL_CLASSES[class_id][0]


def class_family(class_id: str) -> str:
    return KERNEL_CLASSES[class_id][1]


@dataclasses.dataclass(frozen=True, order=True)
class KernelInstance:
    """One concrete kernel: a class plus its numeric shape parameters.

    ``params`` must contain an entry for every axis of the class and may
    contain extra structural-numeric parameters (``H``, ``D``, ``window``...).
    """

    class_id: str
    params: tuple[tuple[str, int], ...]
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.class_id not in KERNEL_CLASSES:
            raise ValueError(f"unknown kernel class: {self.class_id!r}")
        missing = [a for a in class_axes(self.class_id) if a not in dict(self.params)]
        if missing:
            raise ValueError(
                f"instance of {self.class_id} missing axis extents {missing}; got {self.params}"
            )

    @staticmethod
    def make(class_id: str, dtype: str = "bfloat16", **params: int) -> "KernelInstance":
        return KernelInstance(
            class_id=class_id,
            params=tuple(sorted((k, int(v)) for k, v in params.items())),
            dtype=dtype,
        )

    @property
    def p(self) -> dict[str, int]:
        return dict(self.params)

    def extent(self, axis: str) -> int:
        return dict(self.params)[axis]

    def workload_key(self) -> str:
        """Hash of class + shape params + dtype, memoized on the instance."""
        key = self.__dict__.get("_workload_key")
        if key is None:
            blob = json.dumps(
                {"class": self.class_id, "params": list(self.params), "dtype": self.dtype},
                sort_keys=True,
            )
            key = hashlib.sha1(blob.encode()).hexdigest()[:16]
            object.__setattr__(self, "_workload_key", key)
        return key

    def to_json(self) -> dict:
        return {"class_id": self.class_id, "params": list(self.params), "dtype": self.dtype}
