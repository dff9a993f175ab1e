"""Extract kernel workloads from an (architecture × shape) cell.

A copy of ``repro.core.extract`` (the port imports nothing of ``repro``).

This is the bridge between the model substrate and the transfer-tuning
core: it enumerates every Pallas-dispatched kernel the model executes for a
given shape cell — with *local* (post-sharding) extents, since schedules are
tuned for the per-chip problem — together with use counts (paper Table 1).

``dp``/``tp`` are the data(+pod) and model axis sizes of the target mesh
(1/1 = single-chip tuning, the paper's setting).
"""
from __future__ import annotations

import math
from typing import Sequence

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.workload import KernelInstance, KernelUse, dedup_uses


def _div(n: int, k: int) -> int:
    """Local extent of a dim sharded over k shards (GSPMD pads non-divisible
    dims, so the per-shard extent is the ceiling)."""
    return max(1, math.ceil(n / k)) if k > 1 else n


def extract_kernels(cfg: ArchConfig, shape: ShapeConfig, *, dp: int = 1,
                    tp: int = 1) -> list[KernelUse]:
    d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    h, kv = cfg.n_heads, cfg.n_kv_heads
    dt = cfg.dtype
    decode = shape.kind == "decode"
    # chunk_prefill: seq_len tokens of one sequence attending into a cache of
    # ctx_len positions (paged serving's interleaved prefill slices).
    # verify: the speculative k+1-position verify burst — same prefill-like
    # attention geometry (short Q against a long cached KV), which is exactly
    # why chunk-prefill donors transfer onto it; unlike chunk_prefill the lm
    # head projects every position (acceptance needs all k+1 distributions).
    chunk = shape.kind in ("chunk_prefill", "verify")
    ctx = shape.ctx_len if chunk and shape.ctx_len else shape.seq_len
    b_local = _div(shape.global_batch, dp)
    s = shape.seq_len
    tokens = b_local if decode else b_local * s
    uses: list[KernelUse] = []

    def add(class_id: str, count: int, tag: str, **params):
        uses.append(KernelUse(KernelInstance.make(class_id, dtype=dt, **params),
                              use_count=count, tag=tag))

    kinds = cfg.layer_kinds
    n_attn = sum(1 for k_ in kinds if k_ in ("G", "L"))
    n_local = sum(1 for k_ in kinds if k_ == "L")
    n_global = n_attn - n_local
    n_rec = sum(1 for k_ in kinds if k_ == "R")

    # ---- attention layers ----------------------------------------------------
    if n_attn:
        add("matmul", 1 * n_attn, "attn.wq", M=tokens, N=_div(h * hd, tp), K=d)
        add("matmul", 2 * n_attn, "attn.wkv", M=tokens, N=max(_div(kv * hd, tp), hd), K=d)
        add("matmul", 1 * n_attn, "attn.wo", M=tokens, N=d, K=_div(h * hd, tp))
        q_len = 1 if decode else s
        h_loc = max(_div(h, tp), 1)
        if n_global:
            cls = "flash_attention_softcap" if cfg.attn_softcap > 0 else "flash_attention_causal"
            add(cls, n_global, "attn.global", Q=q_len, KV=ctx if chunk else s,
                H=h_loc, D=hd, B=b_local)
        if n_local:
            cls = "flash_attention_swa" if len(set(kinds)) == 1 else "flash_attention_local"
            if decode:
                kv_len = min(cfg.window, s)
            elif chunk:  # [ring prefix ‖ chunk]
                kv_len = min(cfg.window or ctx, ctx) + s
            else:
                kv_len = s
            add(cls, n_local, "attn.local", Q=q_len, KV=kv_len, H=h_loc, D=hd,
                B=b_local, window=cfg.window)
        # per-attention-layer FFN
        if cfg.n_experts > 0:
            e_loc = _div(cfg.n_experts, tp)
            ep = cfg.n_experts % tp == 0 and tp > 1
            f_loc = f if ep else _div(f, tp)
            routed = max(tokens * cfg.moe_topk // (tp if ep else 1), 1)
            add("moe_router", n_attn, "moe.router", M=tokens, N=cfg.n_experts, K=d)
            add("moe_gemm_silu_glu", n_attn, "moe.up", M=routed, N=2 * f_loc, K=d,
                E=e_loc if ep else cfg.n_experts)
            add("moe_gemm", n_attn, "moe.down", M=routed, N=d, K=f_loc,
                E=e_loc if ep else cfg.n_experts)
        else:
            _add_dense_mlp(add, cfg, tokens, tp, n_attn, d, f)

    # ---- recurrent layers ------------------------------------------------------
    if n_rec:
        t_len = 1 if decode else s
        if cfg.family == "ssm":  # rwkv6
            add("matmul", 4 * n_rec, "rwkv.proj", M=tokens, N=_div(d, tp), K=d)
            add("matmul", 1 * n_rec, "rwkv.decay_a", M=tokens, N=64, K=d)
            add("matmul", 1 * n_rec, "rwkv.decay_b", M=tokens, N=_div(d, tp), K=64)
            add("matmul", 1 * n_rec, "rwkv.wo", M=tokens, N=d, K=_div(d, tp))
            add("rwkv6_scan", n_rec, "rwkv.scan", T=t_len, C=_div(d, tp), D=hd, B=b_local)
            add("matmul", 1 * n_rec, "rwkv.ck", M=tokens, N=_div(f, tp), K=d)
            add("matmul", 1 * n_rec, "rwkv.cv", M=tokens, N=d, K=_div(f, tp))
            add("matmul", 1 * n_rec, "rwkv.cr", M=tokens, N=_div(d, tp), K=d)
        else:  # griffin
            w = cfg.rnn_width or d
            add("matmul", 2 * n_rec, "griffin.in", M=tokens, N=_div(w, tp), K=d)
            add("matmul", 1 * n_rec, "griffin.out", M=tokens, N=d, K=_div(w, tp))
            add("rglru_scan", n_rec, "griffin.scan", T=t_len, C=_div(w, tp), B=b_local)
            _add_dense_mlp(add, cfg, tokens, tp, n_rec, d, f)

    # ---- encoder (whisper) --------------------------------------------------------
    if cfg.encoder_layers:
        enc_tokens = b_local * cfg.encoder_seq
        ne = cfg.encoder_layers
        add("matmul", 3 * ne, "enc.qkv", M=enc_tokens, N=_div(h * hd, tp), K=d)
        add("matmul", 1 * ne, "enc.wo", M=enc_tokens, N=d, K=_div(h * hd, tp))
        add("flash_attention_bidir", ne, "enc.attn", Q=cfg.encoder_seq,
            KV=cfg.encoder_seq, H=max(_div(h, tp), 1), D=hd, B=b_local)
        _add_dense_mlp(add, cfg, enc_tokens, tp, ne, d, f)
        # decoder cross-attention
        q_len = 1 if decode else s
        add("matmul", 1 * cfg.n_layers, "dec.cross_q", M=tokens, N=_div(h * hd, tp), K=d)
        add("matmul", 2 * cfg.n_layers, "dec.cross_kv", M=enc_tokens,
            N=max(_div(kv * hd, tp), hd), K=d)
        add("flash_attention_cross", cfg.n_layers, "dec.cross", Q=q_len,
            KV=cfg.encoder_seq, H=max(_div(h, tp), 1), D=hd, B=b_local)

    # ---- vlm projector ---------------------------------------------------------------
    if cfg.vision_tokens and not decode:
        add("matmul", 1, "vlm.proj", M=b_local * cfg.vision_tokens, N=_div(d, tp), K=d)

    # ---- lm head ------------------------------------------------------------------------
    head_cls = "matmul_lmhead_softcap" if cfg.final_softcap > 0 else "matmul_lmhead"
    # decode and chunk_prefill project logits for the last position only;
    # verify projects all k+1 positions (acceptance compares each of them)
    head_tokens = b_local if (decode or shape.kind == "chunk_prefill") else tokens
    add(head_cls, 1, "lm_head", M=head_tokens, N=_div(cfg.vocab_size, tp), K=d)

    return dedup_uses(uses)


def _add_dense_mlp(add, cfg: ArchConfig, tokens: int, tp: int, count: int,
                   d: int, f: int) -> None:
    f_loc = _div(f, tp)
    if cfg.mlp_kind == "swiglu":
        add("matmul_silu_glu", count, "mlp.up", M=tokens, N=2 * f_loc, K=d)
        add("matmul", count, "mlp.down", M=tokens, N=d, K=f_loc)
    elif cfg.mlp_kind == "geglu":
        add("matmul_gelu_glu", count, "mlp.up", M=tokens, N=2 * f_loc, K=d)
        add("matmul", count, "mlp.down", M=tokens, N=d, K=f_loc)
    else:
        if cfg.mlp_bias:
            add("matmul_bias_gelu", count, "mlp.up", M=tokens, N=f_loc, K=d)
            add("matmul_bias", count, "mlp.down", M=tokens, N=d, K=f_loc)
        else:
            add("matmul_bias_gelu", count, "mlp.up", M=tokens, N=f_loc, K=d)
            add("matmul", count, "mlp.down", M=tokens, N=d, K=f_loc)
