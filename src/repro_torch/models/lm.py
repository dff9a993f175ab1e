"""Decoder-only LM stack: dense and MoE attention layers, recurrent
(rwkv6, griffin) layers and the VLM's vision prefix (the counterpart of
``repro.models.lm``).

The reference stacks each layer-pattern position's params along a leading
axis and runs ``jax.lax.scan`` over the repeats plus explicit tail layers.
Here ``params["layers"]`` and ``cache["layers"]`` are plain lists in layer
order and a Python loop walks them (:mod:`repro_torch.convert` unstacks the
reference's pytrees into this layout).

Entry points (bundled per config by :mod:`repro_torch.models.build`):
  forward(params, batch)                    — full-sequence logits
  loss_fn(params, batch)                    — next-token cross-entropy (+ 0.01·aux)
  prefill(params, batch, max_len)           — last-position logits + filled cache
  prefill_chunk(params, cache, tok, off)    — one prompt chunk at offset ``off``
  decode_step(params, cache, tok)           — one token per slot, cache updated in place
  verify_step(params, cache, tok, off)      — k+1 speculative positions per lane

A vision-prefixed arch (internvl2) takes ``batch["patch_embeds"]`` (B, P, D)
beside the tokens: the stub frontend's patch embeddings, projected by
``vis_proj`` through the matmul kernel and prepended to the text, so
``forward`` returns logits over P + S positions and a cache holds P +
``max_len`` positions.  Such an arch has no chunked prefill and no verify
(``ValueError``, as in the reference).

Each takes ``provider``, the :class:`~repro_torch.kernels.ops.ScheduleProvider`
every kernel op resolves its schedule through (None: the process default),
passed down to every op as the reference passes it.

Training: ``forward`` and ``loss_fn`` take ``remat`` (default on, as the
reference's).  Under autograd each layer then runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, the
counterpart of the reference's ``jax.checkpoint`` around each layer group,
under the policy ``distributed.context.remat_policy`` names (:func:`rematted`):
``full`` saves nothing inside a layer and recomputes it in the backward;
``dots`` saves the outputs of every K1 launch in the layer (the reference's
``dots_with_no_batch_dims_saveable``: its ``ref.matmul`` is a dot with no
batch dimension; the MoE expert GEMM, a ``vmap``'d dot, has one and is
recomputed, as are norms, attention and the scans).  Neither changes a
number.  A tied embedding is one parameter,
``embed``: the LM head launches on its transposed copy ``embed_t`` and its
gradient reaches ``embed`` (``ops.matmul``'s ``transpose_of``), so
``embed_t`` is no leaf of :func:`trainable` and is rebuilt from ``embed``
after every update (:func:`retie`).

Sharded training (:mod:`repro_torch.distributed`): under a param gather
(``distributed.context.gathered_params``) the params are this rank's shards.
:func:`forward` gathers the non-layer params once (a tied head's ``embed_t``
is rebuilt from the gathered ``embed``) and each layer's params inside the
function :func:`rematted` wraps, so under remat the backward gathers them
again and a layer's gathered weights live only while it runs.  Under the
gather's tensor-parallel context (``fsdp_tp``) a gather keeps each leaf's
``model`` shard local: the residual stream holds D/m columns between
layers, each block all-gathers it before its norms and reduce-scatters its
row-parallel products back into it (``context.gather_residual``,
``scatter_residual``), and the embedding, head and loss are
vocab-parallel where the vocabulary splits (:func:`lookup`,
:func:`next_token_nll`).  Without a gather nothing changes.

Sharded serving (``launch.steps.make_sharded_serve_step``): :func:`prefill`
and :func:`decode_step` gather their params as :func:`forward` does, and
:func:`init_cache` allocates this rank's cache shards under the step's
cache layout (``distributed.context.sharded_cache``).  Under tensor-parallel
compute the logits are this rank's vocabulary shard where ``model`` splits
the vocabulary.  Under sequence parallelism (prefill) each rank embeds and
runs its S/m positions (a vision prefix's among them), the last real
position's row is taken to every rank, and each computes its vocabulary
shard of the logits from the whole head.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
                                    set_checkpoint_early_stop)

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.context import (block_io, cache_layout, gather_residual,
                                             gathered_params, param_gather, remat_policy,
                                             scatter_residual, sp_context, tensor_parallel,
                                             tp_context)
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpm
from repro_torch.models import recurrent as rec
from repro_torch.models.common import apply_norm, dense_init, dtype_of, embed_init, norm_params
from repro_torch.tree import leaves


# ---------------------------------------------------------------------------
# Per-block params / apply
# ---------------------------------------------------------------------------


def uses_moe(cfg: ArchConfig, kind: str) -> bool:
    """Whether a layer of ``kind`` has a MoE MLP (griffin's R blocks keep a
    dense one)."""
    return kind != "R" and cfg.n_experts > 0


def block_params(gen: torch.Generator, cfg: ArchConfig, kind: str) -> dict:
    if kind == "R" and cfg.family == "ssm":
        return rec.rwkv_params(gen, cfg)
    dt = dtype_of(cfg.dtype)
    mixer = ({"rnn": rec.griffin_params(gen, cfg)} if kind == "R"
             else {"attn": attn.attn_params(gen, cfg)})
    moe = uses_moe(cfg, kind)
    return {
        "ln1": norm_params(cfg.d_model, cfg.norm, dt, gen.device),
        **mixer,
        "ln2": norm_params(cfg.d_model, cfg.norm, dt, gen.device),
        **({"moe": mlpm.moe_params(gen, cfg)} if moe else {"mlp": mlpm.mlp_params(gen, cfg)}),
    }


def _norm(p: dict, cfg: ArchConfig, x: torch.Tensor, verify: bool = False) -> torch.Tensor:
    """``apply_norm``; under ``verify``, once per position at decode's
    (B, 1, D) shape.  A CUDA row reduction sums in an order set by how many
    rows it reduces, and a verify position must take the bits plain decode
    takes."""
    if not verify:
        return apply_norm(p, x, cfg.norm)
    return torch.cat([apply_norm(p, x[:, j:j + 1].contiguous(), cfg.norm)
                      for j in range(x.shape[1])], dim=1)


def apply_mixer(p: dict, cfg: ArchConfig, kind: str, x: torch.Tensor, *,
                positions: torch.Tensor | None, pos: torch.Tensor | None,
                cache: dict | None, decode: bool, off=None, verify: bool = False,
                provider=None) -> tuple[torch.Tensor, dict | None]:
    """A norm-mixer-MLP block's first half: (the mixer's output to add to
    the residual stream x, cache written).  ``off`` (an int) selects the
    chunked-prefill attention path; ``verify`` reads ``off`` as per-lane
    (B,) offsets of the speculative verify path (attention only)."""
    if kind == "R" and verify:
        raise ValueError("speculative verify does not support recurrent layers")
    xn = _norm(p["ln1"], cfg, gather_residual(x), verify)
    if kind == "R":
        a, c = rec.griffin_block(p["rnn"], cfg, xn, cache=cache, provider=provider)
    elif decode:
        a, c = attn.attn_decode(p["attn"], cfg, xn, kind, pos=pos, cache=cache,
                                provider=provider)
    elif verify:
        a, c = attn.attn_verify(p["attn"], cfg, xn, kind, off=off, cache=cache,
                                provider=provider)
    elif off is not None:
        a, c = attn.attn_chunk(p["attn"], cfg, xn, kind, positions=positions, off=off,
                               cache=cache, provider=provider)
    else:
        a, c = attn.attn_forward(p["attn"], cfg, xn, kind, positions=positions, cache=cache,
                                 provider=provider)
    return a, c


def ffn_input(p: dict, cfg: ArchConfig, x: torch.Tensor, verify: bool = False) -> torch.Tensor:
    """What the block's MLP or MoE reads from the residual stream x."""
    return _norm(p["ln2"], cfg, gather_residual(x), verify)


def apply_ffn(p: dict, cfg: ArchConfig, x: torch.Tensor, provider=None,
              verify: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """A norm-mixer-MLP block's second half: (the MLP's or MoE's output to
    add to the residual stream x, aux loss)."""
    xn = ffn_input(p, cfg, x, verify)
    if "moe" in p:
        y, aux = mlpm.moe_apply(p["moe"], cfg, xn, provider=provider)
        return scatter_residual(y), aux
    return (mlpm.mlp_apply(p["mlp"], cfg, xn, provider=provider),
            torch.zeros((), dtype=torch.float32, device=x.device))


def apply_block(p: dict, cfg: ArchConfig, kind: str, x: torch.Tensor, *,
                positions: torch.Tensor | None, pos: torch.Tensor | None,
                cache: dict | None, decode: bool, off=None, verify: bool = False,
                provider=None) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """Returns (x, cache written, aux loss).  Recurrent blocks carry their
    state through ``cache`` at prefill, chunked prefill and decode alike, so
    they need no chunk path; the aux loss is the MoE load-balance loss, zero
    for any other block.  ``off`` and ``verify``: see :func:`apply_mixer`."""
    if kind == "R" and cfg.family == "ssm":  # rwkv blocks apply their own norms
        if verify:
            raise ValueError("speculative verify does not support recurrent layers")
        x, c = rec.rwkv_block(p, cfg, x, cache=cache, provider=provider)
        return x, c, torch.zeros((), dtype=torch.float32, device=x.device)
    with block_io("mixer_ffn"):
        a, c = apply_mixer(p, cfg, kind, x, positions=positions, pos=pos, cache=cache,
                           decode=decode, off=off, verify=verify, provider=provider)
        x = x + a
        y, aux = apply_ffn(p, cfg, x, provider=provider, verify=verify)
    return x + y, c, aux


# ---------------------------------------------------------------------------
# Stack construction
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random params drawn from ``gen`` on ``gen.device``."""
    dt = dtype_of(cfg.dtype)
    params: dict[str, Any] = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt)}
    if cfg.vision_tokens:
        params["vis_proj"] = dense_init(gen, cfg.d_model, cfg.d_model, dt)
    params["layers"] = [block_params(gen, cfg, kind) for kind in cfg.layer_kinds]
    params["final_norm"] = norm_params(cfg.d_model, cfg.norm, dt, gen.device)
    if cfg.tie_embeddings:
        params["embed_t"] = tied_head(params["embed"])
    else:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt)
    return params


def tied_head(embed: torch.Tensor) -> torch.Tensor:
    """The LM head's w of a tied embedding: one transposed, contiguous copy
    (d_model, vocab), built once with the params and held beside them, so
    the head launches on it without copying the embedding at every call."""
    return embed.T.contiguous()


def trainable(params: dict) -> dict:
    """The params a gradient step updates: all but a tied head's
    ``embed_t``, which is ``embed``'s copy."""
    return {k: v for k, v in params.items() if k != "embed_t"}


@torch.no_grad()
def retie(params: dict) -> dict:
    """Rebuild ``embed_t`` from ``embed`` in place (after an update)."""
    if "embed_t" in params:
        params["embed_t"].copy_(params["embed"].T)
    return params


def _lm_head(params: dict, cfg: ArchConfig, h: torch.Tensor, provider=None) -> torch.Tensor:
    if cfg.tie_embeddings:
        w, tied = params["embed_t"], dict(transpose_of=params["embed"])
    else:
        w, tied = params["lm_head"], {}
    sp = sp_context()
    if sp is not None and sp.vocab_parallel:     # this rank's vocabulary shard, of a whole head
        w, tied = sp.head(w), {}
    if cfg.final_softcap > 0:
        return ops.matmul(h, w, class_id="matmul_lmhead_softcap", softcap=cfg.final_softcap,
                          provider=provider, **tied)
    return ops.matmul(h, w, class_id="matmul_lmhead", provider=provider, **tied)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The ``dots`` policy: K1's forward op (``kernels.matmul.matmul_op``)
    is saved, every other op recomputed (a param gather too: a layer's
    gathered weights are never kept)."""
    if op is torch.ops.repro_torch.matmul.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_save_dots)


def rematted(fn, remat: bool):
    """``fn`` under ``torch.utils.checkpoint`` when ``remat`` is on and a
    tensor among its arguments (params included) requires grad under
    autograd; ``fn`` itself otherwise.  The policy is the forward's
    ``remat_policy()``: ``full`` recomputes all of ``fn`` in the backward;
    ``dots`` runs it under ``kernels.matmul.saving_dots`` and keeps K1's
    outputs (:func:`_save_dots`), so the recompute launches no K1 forward
    and the backward of the gelu and GLU classes reads their Z.  The
    recompute runs under the ops backend, the param gather, the
    tensor-parallel context and the policy the forward ran under: each is
    thread-local, and the backward of CUDA tensors runs on autograd's own
    thread.  Under tensor-parallel compute the recompute runs the whole
    layer (no early stop), so it issues the layer's collectives again, in
    one order on every rank."""
    if not remat:
        return fn
    backend, gather, dots = ops.current_backend(), param_gather(), remat_policy() == "dots"
    tp = tp_context()

    def replayable(*args):
        with (ops.use_backend(backend), gathered_params(gather), tensor_parallel(tp),
              mm.saving_dots(dots)):
            return fn(*args)

    def run(*args):
        if not (torch.is_grad_enabled() and any(
                isinstance(t, torch.Tensor) and t.requires_grad for t in leaves(args))):
            return fn(*args)
        kw = {"context_fn": _dots_contexts} if dots else {}
        if tp is None:
            return checkpoint(replayable, *args, use_reentrant=False, **kw)
        with set_checkpoint_early_stop(False):
            return checkpoint(replayable, *args, use_reentrant=False, **kw)

    return run


def gathered(fn, gather):
    """``fn(p, *rest)`` with its params ``p`` gathered first (``gather``
    None: ``fn`` itself)."""
    if gather is None:
        return fn
    return lambda p, *rest: fn(gather(p), *rest)


#: the keys of a param tree (decoder-only or encoder-decoder) whose entries
#: are layers, gathered one at a time inside :func:`rematted`
LAYER_KEYS = ("layers", "encoder", "decoder")


def gather_top(params: dict, cfg: ArchConfig, gather) -> dict:
    """A sharded tree with every param but the layers' gathered, and a tied
    head's ``embed_t`` rebuilt from the gathered ``embed`` (no gradient: the
    head's gradient reaches ``embed`` through ``transpose_of``)."""
    out = {k: v if k in LAYER_KEYS else gather(v) for k, v in params.items() if k != "embed_t"}
    if cfg.tie_embeddings:
        with torch.no_grad():
            out["embed_t"] = tied_head(out["embed"])
    return out


def lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' rows of ``embed``, in the residual stream's layout.
    Under vocab-parallel compute ``embed`` is this rank's vocabulary shard:
    the tokens in its range are looked up, the others zeroed, and the
    ranks' rows summed (one addend is not zero, so the sum is exact)."""
    tp = tp_context()
    if tp is None:
        return embed[tokens.long()]
    if not tp.vocab_parallel:
        return tp.local(embed[tokens.long()])
    n = embed.shape[0]
    t = tokens.long() - tp.rank * n
    mine = (t >= 0) & (t < n)
    h = embed[torch.where(mine, t, 0)]
    return tp.scatter(torch.where(mine[..., None], h, torch.zeros((), dtype=h.dtype,
                                                                  device=h.device)))


def _embed(params: dict, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    h = lookup(params["embed"], tokens)
    if cfg.tie_embeddings:  # gemma-family embedding scaling
        h = (h.float() * cfg.d_model ** 0.5).to(h.dtype)
    return h


def _stack_pass(params: dict, cfg: ArchConfig, h: torch.Tensor, *, positions: torch.Tensor,
                caches: list | None, off=None, verify: bool = False, remat: bool = False,
                provider=None, gather=None) -> tuple[torch.Tensor, list | None, torch.Tensor]:
    """All layers; returns (h, caches written, the layers' summed aux loss).
    ``off`` (with caches) runs the chunked-prefill path, ``verify`` the
    speculative verify path (``off`` per lane); ``remat`` (no caches) runs
    each layer under :func:`rematted`, its params gathered inside it by
    ``gather`` (sharded training)."""
    new = [] if caches is not None else None
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for j, kind in enumerate(cfg.layer_kinds):
        if caches is None:
            def layer(p, hh, kind=kind):
                out, _, a = apply_block(p, cfg, kind, hh, positions=positions, pos=None,
                                        cache=None, decode=False, off=off, verify=verify,
                                        provider=provider)
                return out, a
            h, a = rematted(gathered(layer, gather), remat)(params["layers"][j], h)
        else:
            p = params["layers"][j] if gather is None else gather(params["layers"][j])
            h, c_out, a = apply_block(p, cfg, kind, h, positions=positions, pos=None,
                                      cache=caches[j], decode=False, off=off, verify=verify,
                                      provider=provider)
            new.append(c_out)
        aux = aux + a
    return h, new, aux


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.long, device=device).expand(b, s)


def _embed_inputs(params: dict, cfg: ArchConfig, batch: dict, provider=None) -> torch.Tensor:
    """The tokens' embeddings, behind the projected patch embeddings of a
    vision-prefixed arch (under sequence parallelism, this rank's positions
    of the two)."""
    tokens, patches = batch["tokens"], batch.get("patch_embeds")
    sp = sp_context()
    if sp is not None:
        a, b, p = sp.offset, sp.offset + sp.local, cfg.vision_tokens
        tokens = tokens[:, max(a, p) - p:max(b, p) - p]
        if p:
            patches = patches[:, min(a, p):min(b, p)]
    h = _embed(params, cfg, tokens)
    if not cfg.vision_tokens or patches.shape[1] == 0:
        return h
    vis = ops.matmul(patches.to(h.dtype), params["vis_proj"], provider=provider)
    tp = tp_context()
    if tp is not None and not tp.d_sharded:     # whole on every rank: it enters once
        vis = tp.local(vis)
    return torch.cat([vis, h], dim=1)


def forward(params: dict, cfg: ArchConfig, batch: dict, *, remat: bool = True,
            provider=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits and the auxiliary loss: the MoE layers' summed
    load-balance loss (zero without MoE layers).  A vision-prefixed arch's
    logits cover the prefix and the text.  ``remat`` and sharded params:
    see the module."""
    gather = param_gather()
    if gather is not None:
        params = gather_top(params, cfg, gather)
    h = _embed_inputs(params, cfg, batch, provider)
    b, s, _ = h.shape
    h, _, aux = _stack_pass(params, cfg, h, positions=_positions(b, s, h.device), caches=None,
                            remat=remat, provider=provider, gather=gather)
    h = apply_norm(params["final_norm"], gather_residual(h), cfg.norm)
    return _lm_head(params, cfg, h, provider=provider), aux


def next_token_nll(logits: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[tgt], in f32.  Under vocab-parallel compute
    ``logits`` are this rank's vocabulary shard: the max, the sum of
    exponentials and the target's logit are reduced over ``model``."""
    tp = tp_context()
    if tp is not None and tp.vocab_parallel:
        return _vocab_parallel_nll(logits, tgt, tp)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, tgt.long()[..., None]).squeeze(-1)


def _vocab_parallel_nll(logits: torch.Tensor, tgt: torch.Tensor, tp) -> torch.Tensor:
    z = logits.float()
    n = z.shape[-1]
    zmax = tp.max(z.amax(dim=-1))
    sumexp = torch.exp(z - zmax[..., None]).sum(dim=-1)
    t = tgt.long() - tp.rank * n
    mine = (t >= 0) & (t < n)
    zt = torch.gather(z, -1, torch.where(mine, t, 0)[..., None]).squeeze(-1)
    sumexp, zt = tp.sum(torch.stack([sumexp, torch.where(mine, zt, 0.0)])).unbind()
    return torch.log(sumexp) + zmax - zt


def loss_fn(params: dict, cfg: ArchConfig, batch: dict, *, remat: bool = True,
            provider=None) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy (masked by ``batch["mask"]`` where given) plus
    0.01·aux.  Returns (total, {"ce", "aux"}).  A vision prefix's last
    position predicts the first text token.  Under a param gather (sharded
    training) the masked mean divides by the global batch's count
    (``ParamGather.batch_count``), so the ranks' losses average to the
    global batch's masked mean."""
    logits, aux = forward(params, cfg, batch, remat=remat, provider=provider)
    p = cfg.vision_tokens
    tokens = batch["tokens"]
    if p:
        pred, tgt = logits[:, p - 1:-1, :], tokens
    else:
        pred, tgt = logits[:, :-1, :], tokens[:, 1:]
    nll = next_token_nll(pred, tgt)
    mask = batch.get("mask")
    if mask is not None:
        m = (mask[:, 1:] if not p else mask).float()
        gather = param_gather()
        count = torch.clamp(m.sum(), min=1.0) if gather is None else gather.batch_count(m.sum())
        ce = (nll * m).sum() / count
    else:
        ce = nll.mean()
    return once(ce + 0.01 * aux), {"ce": ce, "aux": aux}


def once(loss: torch.Tensor) -> torch.Tensor:
    """The loss, whose gradient a tensor-parallel row seeds once (on its
    first rank: every rank of the row computes the same loss)."""
    tp = tp_context()
    return loss if tp is None else tp.once(loss)


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def init_block_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int, device) -> dict:
    if kind == "R":
        if cfg.family == "ssm":
            return rec.init_rwkv_cache(cfg, batch, device)
        return rec.init_griffin_cache(cfg, batch, device)
    return attn.init_attn_cache(cfg, kind, batch, max_len, device)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> dict:
    """``max_len`` counts text positions; the vision prefix is added here.
    Under a sharded serving step's cache layout, this rank's shards of the
    cache of its batch shards (``batch`` rows are this rank's)."""
    layout = cache_layout()
    if layout is not None:
        return layout(lambda b, dev: _init_cache(cfg, b, max_len, dev), batch, device)
    return _init_cache(cfg, batch, max_len, device)


def _init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> dict:
    max_len = max_len + cfg.vision_tokens
    return {
        "layers": [init_block_cache(cfg, kind, batch, max_len, device)
                   for kind in cfg.layer_kinds],
        "t": torch.zeros((batch,), dtype=torch.int32, device=device),  # per-slot positions
    }


def prefill(params: dict, cfg: ArchConfig, batch: dict, *, max_len: int,
            true_len: int | None = None, provider=None) -> tuple[torch.Tensor, dict]:
    """Process the prompt; returns (last-position logits (B, V), cache).

    ``true_len`` marks the number of real tokens when the prompt is
    right-padded to a bucket: logits come from the last real position and the
    decode position starts there (pad rows sit beyond it and are overwritten
    before they become visible).  It counts text tokens: a vision prefix
    sits before them.  Sharded (see the module): params gathered, caches
    and logits this rank's shards."""
    gather = param_gather()
    if gather is not None:
        params = gather_top(params, cfg, gather)
    sp = sp_context()
    h = _embed_inputs(params, cfg, batch, provider)
    b, s_here, _ = h.shape
    s, off = (sp.seq, sp.offset) if sp is not None else (s_here, 0)
    t = s if true_len is None else int(true_len) + cfg.vision_tokens
    if not cfg.vision_tokens + 1 <= t <= s:
        raise ValueError(f"true_len {true_len} outside 1..{s - cfg.vision_tokens}")
    caches = init_cache(cfg, b, max_len, h.device)
    h, layers, _ = _stack_pass(params, cfg, h, positions=off + _positions(b, s_here, h.device),
                               caches=caches["layers"], provider=provider, gather=gather)
    row = h[:, t - 1:t, :] if sp is None else sp.row_at(h, t - 1)
    h_last = apply_norm(params["final_norm"], gather_residual(row), cfg.norm)
    logits = _lm_head(params, cfg, h_last, provider=provider)
    cache = {"layers": layers,
             "t": torch.full((b,), t, dtype=torch.int32, device=h.device)}
    return logits[:, 0, :], cache


def prefill_chunk(params: dict, cfg: ArchConfig, cache: dict, tokens: torch.Tensor, off: int,
                  provider=None) -> tuple[torch.Tensor, dict]:
    """One prompt chunk against a partially filled cache: ``tokens`` (B, C)
    cover absolute positions ``off .. off+C-1``.  Returns (last-position
    logits (B, V), cache); attention caches are written in place, recurrent
    layers return fresh state, ``t`` becomes ``off + C``.  Successive chunks
    from ``off = 0`` compute what one :func:`prefill` of the whole prompt
    does."""
    if cfg.vision_tokens:
        raise ValueError("chunked prefill does not support vision-prefix archs")
    off = int(off)
    h = _embed(params, cfg, tokens)
    b, s, _ = h.shape
    positions = off + _positions(b, s, h.device)
    h, layers, _ = _stack_pass(params, cfg, h, positions=positions, caches=cache["layers"],
                               off=off, provider=provider)
    h_last = apply_norm(params["final_norm"], h[:, -1:, :], cfg.norm)
    logits = _lm_head(params, cfg, h_last, provider=provider)
    t = torch.full((b,), off + s, dtype=torch.int32, device=h.device)
    return logits[:, 0, :], {"layers": layers, "t": t}


def verify_step(params: dict, cfg: ArchConfig, cache: dict, tokens: torch.Tensor,
                off: torch.Tensor, provider=None) -> tuple[torch.Tensor, dict]:
    """Speculative verify: ``tokens`` (B, C), the pending token and the
    draft burst, at per-lane absolute offsets ``off`` (B,).  Returns logits
    at every position (B, C, V) and the cache with all C rows written
    (rejected rows are hidden by the validity masks until overwritten).
    Every norm and attention runs once per position at decode's shapes, and
    the projections take the matmul's rows body, whose bits do not depend
    on M: logits at an accepted position are plain decode's, bit for bit."""
    if cfg.vision_tokens:
        raise ValueError("speculative verify does not support vision-prefix archs")
    h = _embed(params, cfg, tokens)
    b, s, _ = h.shape
    off = torch.broadcast_to(torch.as_tensor(off, device=h.device).long(), (b,))
    positions = off[:, None] + torch.arange(s, device=h.device)
    h, layers, _ = _stack_pass(params, cfg, h, positions=positions, caches=cache["layers"],
                               off=off, verify=True, provider=provider)
    h = _norm(params["final_norm"], cfg, h, verify=True)
    logits = _lm_head(params, cfg, h, provider=provider)
    return logits, {"layers": layers, "t": (off + s).to(torch.int32)}


def decode_step(params: dict, cfg: ArchConfig, cache: dict, tokens: torch.Tensor,
                provider=None) -> tuple[torch.Tensor, dict]:
    """tokens: (B,) — one new token per slot. Returns (logits (B, V), cache);
    the cache's KV rows are written in place, recurrent layers return fresh
    state, and ``t`` advances by one.  Sharded: see the module."""
    gather = param_gather()
    if gather is not None:
        params = gather_top(params, cfg, gather)
    pos = cache["t"]
    h = _embed(params, cfg, tokens[:, None])
    layers = []
    for j, kind in enumerate(cfg.layer_kinds):
        p = params["layers"][j] if gather is None else gather(params["layers"][j])
        h, c_out, _ = apply_block(p, cfg, kind, h, positions=None, pos=pos,
                                  cache=cache["layers"][j], decode=True, provider=provider)
        layers.append(c_out)
    h = apply_norm(params["final_norm"], gather_residual(h), cfg.norm)
    logits = _lm_head(params, cfg, h, provider=provider)
    return logits[:, 0, :], {"layers": layers, "t": pos + 1}
