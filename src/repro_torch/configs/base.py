"""Architecture + shape configuration system: a copy of
``repro.configs.base`` (the port imports nothing of ``repro``).

Every assigned architecture is a frozen ``ArchConfig`` in its own module
(``src/repro_torch/configs/<id>.py``) registered under its ``--arch`` id.  Shapes
are the four assigned input-shape cells; applicability rules (which cells run
for which arch) live here so the dry-run, benchmarks, and tests agree.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # MoE
    n_experts: int = 0
    moe_topk: int = 0
    # attention structure
    window: int = 0              # sliding/local window size (0 = full)
    layer_pattern: tuple[str, ...] = ("G",)  # repeated over depth:
    #   G=global attn block, L=local/SWA attn block, R=recurrent block
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    mlp_kind: str = "swiglu"     # swiglu | geglu | gelu
    mlp_bias: bool = False       # biases on MLP projections (starcoder2, whisper)
    pos: str = "rope"            # rope | learned | none
    rope_theta: float = 10000.0
    # encoder-decoder (whisper): encoder layers + stub frontend length
    encoder_layers: int = 0
    encoder_seq: int = 0
    # vlm: stub patch-embedding tokens prepended to the text sequence
    vision_tokens: int = 0
    # recurrent dims
    rnn_width: int = 0           # RG-LRU width (griffin); rwkv uses d_model
    conv_width: int = 4          # temporal conv in griffin recurrent block
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""             # provenance note [source; verified-tier]

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # -- structure helpers ---------------------------------------------------
    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Per-layer kind for all n_layers (pattern repeated + remainder)."""
        pat = self.layer_pattern
        reps, rem = divmod(self.n_layers, len(pat))
        return pat * reps + pat[:rem]

    @property
    def is_attention_free(self) -> bool:
        return all(k == "R" for k in self.layer_kinds)

    @property
    def is_sub_quadratic(self) -> bool:
        """True if decode-state memory is bounded sub-linearly in context
        (recurrent state or windowed KV): gates the long_500k cell."""
        kinds = set(self.layer_kinds)
        if kinds <= {"R", "L"}:
            return True
        # global-attention layers present: sub-quadratic only if windowed
        return self.window > 0 and "G" not in kinds

    @property
    def has_global_full_attention(self) -> bool:
        return "G" in self.layer_kinds and self.window == 0

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, ff, hd = self.d_model, self.d_ff, self.head_dim
        qkv = d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * d
        if self.mlp_kind in ("swiglu", "geglu"):
            mlp = 3 * d * ff
        else:
            mlp = 2 * d * ff
        total = 0
        for kind in self.layer_kinds:
            if kind == "R":
                if self.family == "ssm":  # rwkv6: time-mix ~5 proj + channel-mix
                    total += 5 * d * d + d * d + 2 * d * self.d_ff + self.d_ff * 0
                else:  # griffin recurrent block
                    w = self.rnn_width or d
                    total += 2 * d * w + w * d + self.conv_width * w + 3 * w
                total += mlp if self.family != "ssm" else 0
            else:
                if self.n_experts > 0:
                    total += qkv + d * self.n_experts + self.n_experts * mlp
                else:
                    total += qkv + mlp
            total += 2 * d  # norms
        total += self.vocab_size * d  # token embedding
        if not self.tie_embeddings:
            total += d * self.vocab_size
        if self.encoder_layers:
            total += self.encoder_layers * (qkv + (2 * d * ff) + 2 * d)
            total += self.n_layers * (qkv + 2 * d)  # decoder cross-attention
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only) for 6·N·D."""
        if self.n_experts == 0:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        mlp = 3 * d * ff if self.mlp_kind in ("swiglu", "geglu") else 2 * d * ff
        dense = self.param_count() - self.n_layers * self.n_experts * mlp
        return dense + self.n_layers * self.moe_topk * mlp


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode" | "chunk_prefill" | "verify"
    # chunk_prefill / verify only: total cache context the slice attends
    # into (seq_len is the chunk / burst length itself).  0 elsewhere.
    ctx_len: int = 0


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: "ArchConfig", shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason). Mirrors DESIGN.md §4 applicability table."""
    if shape.name == "long_500k":
        kinds = set(arch.layer_kinds)
        if kinds <= {"R", "L"} or "R" in kinds or arch.window > 0:
            return True, "sub-quadratic decode state (recurrent/windowed layers)"
        if arch.name == "gemma2-2b":
            return True, "alternating local/global: not pure full-attention"
        return False, "pure full-attention arch: 500k KV decode skipped per assignment"
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = (
    "dbrx-132b",
    "mixtral-8x22b",
    "rwkv6-1.6b",
    "stablelm-12b",
    "starcoder2-7b",
    "gemma2-2b",
    "minitron-4b",
    "whisper-medium",
    "recurrentgemma-2b",
    "internvl2-26b",
)

_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}
_REGISTRY: dict[str, ArchConfig] = {}


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        if name not in _MODULE_FOR:
            raise KeyError(f"unknown arch {name!r}; known: {list(_MODULE_FOR)}")
        mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[name]}")
        _REGISTRY[name] = mod.CONFIG
    return _REGISTRY[name]


def all_archs() -> dict[str, ArchConfig]:
    return {a: get_arch(a) for a in ARCH_IDS}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_cells() -> list[tuple[str, str, bool, str]]:
    """Every (arch, shape) cell with its applicability: (arch, shape, runs, reason)."""
    out = []
    for a in ARCH_IDS:
        arch = get_arch(a)
        for s in SHAPES.values():
            ok, why = shape_applicable(arch, s)
            out.append((a, s.name, ok, why))
    return out


# ---------------------------------------------------------------------------
# Reduced (smoke-test) variants: same family/structure, tiny sizes.
# ---------------------------------------------------------------------------


def reduced(arch: ArchConfig) -> ArchConfig:
    pat = arch.layer_pattern
    n_layers = max(len(pat), 2)
    if arch.n_layers % len(pat):
        n_layers += arch.n_layers % len(pat)  # keep a remainder to exercise it
    head_dim = 16
    n_heads = max(2, min(4, arch.n_heads))
    n_kv = max(1, min(arch.n_kv_heads, n_heads))
    d_model = 64
    return dataclasses.replace(
        arch,
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=128,
        vocab_size=512,
        n_experts=min(arch.n_experts, 4),
        moe_topk=min(arch.moe_topk, 2),
        window=min(arch.window, 8) if arch.window else 0,
        encoder_layers=2 if arch.encoder_layers else 0,
        encoder_seq=16 if arch.encoder_seq else 0,
        vision_tokens=4 if arch.vision_tokens else 0,
        rnn_width=64 if arch.rnn_width else 0,
        dtype="float32",
    )
