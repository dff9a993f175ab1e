"""Kernel workloads and kernel classes (paper §4.2): a copy of
``repro.core.workload`` (the port imports nothing of ``repro``), so a kernel
instance has the same workload key in both packages.

A *kernel* is a fused unit of computation dispatched as one Pallas call on
the TPU, one CUDA kernel launch in the port (e.g. a projection GEMM with its bias+activation epilogue, a flash-attention
invocation, a recurrent-scan chunk).

A *kernel class* is the set of kernels sharing the same operator sequence
regardless of tensor shapes — the unit within which auto-schedules are
transferable (paper §3, §4.2).  Structural attributes (epilogue ops,
causality, presence of a window or softcap) are part of the class; numeric
shape parameters (M/N/K, sequence lengths, window sizes) are per-instance.

A *workload key* hashes class + shapes + dtype: Ansor's exact-reuse unit.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Mapping, Sequence

# ---------------------------------------------------------------------------
# Kernel class registry: class_id -> loop axes the scheduler can transform.
# The axes define the schedule space (which tiles exist) for the class.
# ---------------------------------------------------------------------------

MATMUL_AXES = ("M", "N", "K")
ATTENTION_AXES = ("Q", "KV")
SCAN_AXES = ("T", "C")

#: class_id -> (axes, family). Family groups classes that share a kernel
#: template ("matmul", "attention", "scan") — schedules NEVER transfer across
#: class_ids (paper: across-class transfer is future work), but the family
#: tells us which Pallas template + cost model to use.
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
    # --- CNN classes (paper §4.2 Table 1), TPU-adapted as implicit GEMM ----
    # (im2col: M = B·OH·OW, N = C_out, K = C_in·KH·KW) — the matmul family's
    # schedule space and cost model apply directly, which is exactly how
    # convolutions lower on the MXU.
    "conv2d_add": (MATMUL_AXES, "matmul"),
    "conv2d_bias_relu": (MATMUL_AXES, "matmul"),
    "conv2d_bias_add_relu": (MATMUL_AXES, "matmul"),
    "dense_add": (MATMUL_AXES, "matmul"),
    "max_pool2d": (("M", "N", "K"), "matmul"),          # window reduce: K = KH·KW
    "global_avg_pool2d": (("M", "N", "K"), "matmul"),
}


def class_axes(class_id: str) -> tuple[str, ...]:
    return KERNEL_CLASSES[class_id][0]


def class_family(class_id: str) -> str:
    return KERNEL_CLASSES[class_id][1]


def is_known_class(class_id: str) -> bool:
    return class_id in KERNEL_CLASSES


# ---------------------------------------------------------------------------
# Kernel instances
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, order=True)
class KernelInstance:
    """One concrete kernel: a class plus its numeric shape parameters.

    ``params`` must contain an entry for every axis of the class (the loop
    extents the scheduler tiles) and may contain extra structural-numeric
    parameters used by the cost model (e.g. ``H`` heads, ``D`` head_dim,
    ``window``, ``topk``).
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

    @property
    def axes(self) -> tuple[str, ...]:
        return class_axes(self.class_id)

    @property
    def family(self) -> str:
        return class_family(self.class_id)

    def workload_key(self) -> str:
        """Ansor-style unique ID: hash of class + shape params + dtype.

        Memoized on the instance — resolution paths key every lookup by it,
        so the hash is computed once per interned instance, not per call."""
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

    @staticmethod
    def from_json(d: Mapping) -> "KernelInstance":
        return KernelInstance(
            class_id=d["class_id"],
            params=tuple((str(k), int(v)) for k, v in d["params"]),
            dtype=d.get("dtype", "bfloat16"),
        )


@dataclasses.dataclass(frozen=True)
class KernelUse:
    """A kernel instance plus how many times the model invokes it.

    Mirrors paper Table 1's "Use Count": repeated layers share one tuning
    task but weigh proportionally in model cost.
    """

    instance: KernelInstance
    use_count: int = 1
    tag: str = ""  # human label, e.g. "layer.qkv_proj"

    def to_json(self) -> dict:
        return {"instance": self.instance.to_json(), "use_count": self.use_count, "tag": self.tag}

    @staticmethod
    def from_json(d: Mapping) -> "KernelUse":
        return KernelUse(
            instance=KernelInstance.from_json(d["instance"]),
            use_count=int(d["use_count"]),
            tag=d.get("tag", ""),
        )


def dedup_uses(uses: Sequence[KernelUse]) -> list[KernelUse]:
    """Merge identical instances, summing use counts (paper Table 1)."""
    merged: dict[str, KernelUse] = {}
    for u in uses:
        k = u.instance.workload_key()
        if k in merged:
            prev = merged[k]
            merged[k] = KernelUse(prev.instance, prev.use_count + u.use_count, prev.tag)
        else:
            merged[k] = u
    return sorted(merged.values(), key=lambda u: (u.instance.class_id, u.instance.params))


def classes_in(uses: Sequence[KernelUse]) -> list[str]:
    return sorted({u.instance.class_id for u in uses})
