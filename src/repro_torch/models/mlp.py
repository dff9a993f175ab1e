"""MLP and Mixture-of-Experts blocks (the counterpart of ``repro.models.mlp``).

Dense: gated MLPs (swiglu / geglu) keep the interleaved packing the fused GLU
epilogue reads; the plain gelu MLP (minitron) runs its up-projection as
``matmul_bias_gelu`` (with no bias unless ``mlp_bias``).

MoE: the reference's token-dropping sort-based dispatch.  Token-expert pairs
are stably sorted by expert, packed into a fixed (E, capacity, D) buffer
(overflow drops), pushed through the two grouped GEMMs (``ops.moe_gemm``,
kernel K1g) and combined back with the router weights.  Capacity factor 1.25,
dropless (capacity = tokens) while tokens × top-k <= 4096.

Under tensor-parallel compute (``distributed.context.tensor_parallel``)
``w_in`` (and ``b_in``) hold this rank's d_ff columns (a GLU's gate/up
pairs whole) and ``w_out`` the matching rows: the dense block's ``w_out``
is a row-parallel product (``common.row_parallel``: summed over ``model``
into the residual stream, ``b_out`` added once), and the MoE block returns
the rank's partial sums, which the caller reduce-scatters.  The MoE block
reads the whole tokens on every rank of a row, so every rank routes alike.
Expert parallelism (the experts split over ``model``): each rank fills and
runs only its own experts' rows of the dispatch buffer and combines their
contributions, no all-to-all.  The TP fallback: every expert's d_ff is
split, as the dense block's is.  With f32 partial sums (bf16 over more
than one rank) the combine adds a token's contributions in f32 (the
fallback's expert outputs are f32 partial sums themselves), and the
caller's sum over ``model`` casts.

Under sequence parallelism (``distributed.context.sequence_parallel``)
every rank routes its own tokens over every expert, whole.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.context import (constrain_named, f32_partials, param_gather,
                                             tp_context)
from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, dtype_of, glu_init, row_parallel


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


def mlp_apply(p: dict, cfg: ArchConfig, x: torch.Tensor, provider=None) -> torch.Tensor:
    """The MLP's output, in the residual stream's layout."""
    if cfg.mlp_kind == "swiglu":
        h = ops.matmul(x, p["w_in"], class_id="matmul_silu_glu", provider=provider)
        return row_parallel(h, p["w_out"], provider=provider)
    if cfg.mlp_kind == "geglu":
        h = ops.matmul(x, p["w_in"], class_id="matmul_gelu_glu", provider=provider)
        return row_parallel(h, p["w_out"], provider=provider)
    h = ops.matmul(x, p["w_in"], class_id="matmul_bias_gelu", bias=p.get("b_in"),
                   provider=provider)
    return row_parallel(h, p["w_out"], bias=p.get("b_out"), provider=provider)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

CAPACITY_FACTOR = 1.25


def moe_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = dtype_of(cfg.dtype)
    # each stack is allocated once and filled expert by expert, so no list
    # of experts is alive beside it
    router = dense_init(gen, d, e, torch.float32)                             # router kept f32
    w_in = torch.empty((e, d, 2 * f), dtype=dt, device=gen.device)           # (E, D, 2F) interleaved
    for i in range(e):
        glu_init(gen, d, f, dt, out=w_in[i])
    w_out = torch.empty((e, f, d), dtype=dt, device=gen.device)              # (E, F, D)
    for i in range(e):
        w_out[i] = dense_init(gen, f, d, dt)
    return {"router": router, "w_in": w_in, "w_out": w_out}


def moe_route(p: dict, cfg: ArchConfig, x: torch.Tensor,
              provider=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (T, D). Returns (router probs (T, E) f32, renormalised top-k gates
    (T, k), their expert indices (T, k))."""
    logits = ops.matmul(x.float(), p["router"], class_id="moe_router",
                        provider=provider)                                 # (T, E) f32
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k breaks ties toward the lower index and torch.topk promises no
    # order among ties; random f32 probabilities do not tie
    gate_vals, expert_idx = torch.topk(probs, cfg.moe_topk, dim=-1)        # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


class _PairRows(torch.autograd.Function):
    """``x[idx // k]``: the rows of ``x`` (T, D) for token-expert pairs in
    the order ``idx``, a permutation of the T·k pairs in token-major order
    (pair ``p`` is token ``p // k``'s ``p % k``-th choice).  Its gradient
    adds each token's k row gradients one after another in choice order,
    rounding to x's dtype after each add, as the combine adds the forward's
    contributions: the gradient of ``x[idx // k]`` (an index put with
    accumulation over repeated rows) would add in an order that may change
    from run to run on the card."""

    @staticmethod
    def forward(ctx, x, idx, k):
        ctx.save_for_backward(idx)
        ctx.k = k
        return x[idx // k]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        per_pair = torch.empty_like(g)
        per_pair[idx] = g                        # token-major: each pair once
        per_pair = per_pair.reshape(-1, ctx.k, g.shape[-1])
        dx = per_pair[:, 0]
        for j in range(1, ctx.k):
            dx = dx + per_pair[:, j]
        return dx, None, None


def moe_apply(p: dict, cfg: ArchConfig, x: torch.Tensor, provider=None,
              capacity_factor: float = CAPACITY_FACTOR) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Returns (out, aux_loss) — aux is the load-balance loss.

    The dispatch buffer and the output pass ``constrain_named`` where the
    reference pins their shardings (the identity: ``distributed.context``).
    Under expert parallelism ``w_in``'s leading dim is this rank's experts,
    from ``e0``; the pairs routed elsewhere go to the overflow row, and the
    output is the rank's share of the combine."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_topk
    tp = tp_context()
    dt = p["w_in"].dtype
    wide = f32_partials()           # the combine's partial sums in f32
    e_here = p["w_in"].shape[0]
    e0 = tp.rank * e_here if tp is not None and tp.expert_parallel else 0
    t = b * s
    dev = x.device
    xf = x.reshape(t, d)
    probs, gate_vals, expert_idx = moe_route(p, cfg, xf, provider)

    # Load-balance auxiliary loss (Switch-style): E * Σ_e f_e · p_e, over
    # the global batch (under sharded training, both means over the ranks)
    me = probs.mean(dim=0)
    ce = torch.bincount(expert_idx.reshape(-1), minlength=e).float() / (t * k)
    gather = param_gather()
    if gather is not None and gather.aux:
        me, ce = gather.batch_mean(me), gather.batch_mean(ce)
    aux = e * torch.sum(me * ce)

    # --- sort-based dispatch (dropless while t * k <= 4096) ------------------
    if t * k <= 4096:
        cap = t
    else:
        cap = int(max(1, round(t * k / e * capacity_factor)))
    flat_e = expert_idx.reshape(-1)                                         # (T*k,)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    flat_g = gate_vals.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    counts = torch.bincount(se, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=dev) - starts[se]
    keep = (pos < cap) & (se >= e0) & (se < e0 + e_here)
    rows = (se - e0) * cap + pos
    slot = torch.where(keep, rows, e_here * cap)                            # overflow row

    buf = torch.zeros((e_here * cap + 1, d), dtype=x.dtype, device=dev)
    # xf[st], with a gradient summed in a fixed order; kept slots are
    # distinct, and the overflow row is dropped
    buf[slot] = _PairRows.apply(xf, order, k)
    buf = constrain_named(buf[:-1].reshape(e_here, cap, d), "moe_buf")

    h = ops.moe_gemm(buf, p["w_in"], class_id="moe_gemm_silu_glu", provider=provider)
    # the TP fallback's expert outputs are partial sums over d_ff slices
    y = ops.moe_gemm(h, p["w_out"], class_id="moe_gemm", provider=provider,
                     out_f32=wide and not tp.expert_parallel)                 # (E, cap, D)
    y = constrain_named(y, "moe_buf")

    y_flat = y.reshape(e_here * cap, d)
    contrib = torch.where(keep, sg, 0.0)[:, None].to(dt)
    gathered = y_flat[torch.where(keep, rows, 0)] * contrib
    # Combine in a fixed order: the reference's scatter-add adds each token's
    # k contributions in ascending expert order (the pairs are sorted by
    # expert), rounding to x.dtype after each add.  A stable sort by token
    # keeps that order within each token; adding the k columns one after
    # another repeats it, where index_add_ on the card would add in an order
    # that changes from run to run.
    per_token = gathered[torch.argsort(st, stable=True)].reshape(t, k, d)
    out = torch.zeros((t, d), dtype=torch.float32 if wide else dt, device=dev)
    for j in range(k):
        out = out + per_token[:, j]
    out = constrain_named(out, "moe_out")   # combine lands in the token layout
    return out.reshape(b, s, d), aux
