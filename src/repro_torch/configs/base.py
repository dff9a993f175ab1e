"""Architecture configuration: a copy of ``repro.configs.base``'s
``ArchConfig``, ``reduced()`` and ``get_arch()``.

The registry holds only the archs the port can build so far (dense and
recurrent); the others arrive with the slices that port their layers (MoE,
enc-dec, VLM).
"""
from __future__ import annotations

import dataclasses
import importlib


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
    mlp_bias: bool = False
    pos: str = "rope"            # rope | learned | none
    rope_theta: float = 10000.0
    encoder_layers: int = 0
    encoder_seq: int = 0
    vision_tokens: int = 0
    rnn_width: int = 0
    conv_width: int = 4
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Per-layer kind for all n_layers (pattern repeated + remainder)."""
        pat = self.layer_pattern
        reps, rem = divmod(self.n_layers, len(pat))
        return pat * reps + pat[:rem]

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


ARCH_IDS = ("rwkv6-1.6b", "minitron-4b", "recurrentgemma-2b")

_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}
_REGISTRY: dict[str, ArchConfig] = {}


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        if name not in _MODULE_FOR:
            raise KeyError(f"unknown arch {name!r}; the port builds: {list(_MODULE_FOR)}")
        mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[name]}")
        _REGISTRY[name] = mod.CONFIG
    return _REGISTRY[name]


def reduced(arch: ArchConfig) -> ArchConfig:
    """Same family and structure at tiny sizes (f32) — the CPU test size."""
    pat = arch.layer_pattern
    n_layers = max(len(pat), 2)
    if arch.n_layers % len(pat):
        n_layers += arch.n_layers % len(pat)
    head_dim = 16
    n_heads = max(2, min(4, arch.n_heads))
    n_kv = max(1, min(arch.n_kv_heads, n_heads))
    return dataclasses.replace(
        arch,
        n_layers=n_layers,
        d_model=64,
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
