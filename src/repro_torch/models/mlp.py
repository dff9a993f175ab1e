"""Dense MLP blocks (the dense half of ``repro.models.mlp``).

Gated MLPs (swiglu / geglu) keep the interleaved packing the fused GLU
epilogue reads; the plain gelu MLP (minitron) runs its up-projection as
``matmul_bias_gelu`` (with no bias unless ``mlp_bias``).  The MoE half waits
for the slice that ports the grouped GEMM.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, dtype_of, glu_init


def mlp_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg.dtype)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {"w_in": glu_init(gen, d, f, dt), "w_out": dense_init(gen, f, d, dt)}
    p = {"w_in": dense_init(gen, d, f, dt), "w_out": dense_init(gen, f, d, dt)}
    if cfg.mlp_bias:
        p["b_in"] = torch.zeros((f,), dtype=dt, device=gen.device)
        p["b_out"] = torch.zeros((d,), dtype=dt, device=gen.device)
    return p


def mlp_apply(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_kind == "swiglu":
        h = ops.matmul(x, p["w_in"], class_id="matmul_silu_glu")
        return ops.matmul(h, p["w_out"])
    if cfg.mlp_kind == "geglu":
        h = ops.matmul(x, p["w_in"], class_id="matmul_gelu_glu")
        return ops.matmul(h, p["w_out"])
    bias_in = p.get("b_in")
    bias_out = p.get("b_out")
    h = ops.matmul(x, p["w_in"], class_id="matmul_bias_gelu", bias=bias_in)
    cls = "matmul_bias" if bias_out is not None else "matmul"
    return ops.matmul(h, p["w_out"], class_id=cls, bias=bias_out)
