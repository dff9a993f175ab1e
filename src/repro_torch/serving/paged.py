"""Iteration-level continuous batching over a paged KV cache (the counterpart
of ``repro.serving.paged``).

The :class:`PagedServingEngine` replaces the slot engine's fixed batch with
a lane/page design:

* **Lanes** — ``decode_batch`` decode lanes share one batched cache, and
  requests flow through lanes at iteration (decode step) granularity: every
  :meth:`step` admits waiting requests into free lanes, advances prefills
  by one chunk each, decodes every decoding lane and retires finished
  requests.
* **Pages** — the full-length KV leaves live in one flat pool of fixed-size
  pages (:class:`~repro_torch.serving.pages.PageTable`).  A request holds
  ``ceil(tokens / page_size)`` pages at any instant; decode gathers each
  lane's pages into a dense per-lane view, laid out as the slot engine's
  cache, and scatters back only the newly written row.  Ring (windowed)
  caches and recurrent state stay dense lane strips.
* **Chunked prefill** — prompts advance ``chunk`` tokens per step,
  interleaved with decode, the final chunk at its exact remainder length:
  no padding anywhere.
* **Preemption** — when the pool cannot grow the decoding requests, the
  youngest decoder is evicted and re-queued at the front with
  recompute-on-resume (prompt + generated so far re-prefilled, the pending
  token re-fed).
* **Speculative decoding** — with a draft model and ``spec_k > 0``, lanes
  whose draft cache is in sync run a draft-then-verify burst instead of a
  plain decode step (:meth:`_spec_step`); the committed stream equals plain
  greedy decode's.

The host logic is the reference's.  Its jitted functions are plain
functions on tensors here: a gather is ``index_select`` on the pool axis, a
scatter ``index_copy_`` into the pool, a lane update ``torch.where`` with
the lane mask, and the draft burst's scan a loop of ``spec_k + 1`` draft
decode steps.  The model writes attention caches in place, so every
function hands it copies where the reference's functional update would
leave the stored cache untouched: gathered views are copies, lane leaves the
model writes in place are cloned before a batched decode or verify, and
the draft's cache is cloned before a burst.

Execution plans key on (decode-batch, page-size):
:func:`~repro_torch.core.resolution.plan_serving_paged` freezes the paged
decode cell plus one ``chunk_prefill`` cell per chunk length (and the
verify and draft cells when speculating); the engine re-plans at step
boundaries like the slot engine.
"""
from __future__ import annotations

import contextlib
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.core.resolution import ExecutionPlan, plan_serving_paged
from repro_torch.models.build import Model
from repro_torch.obs import NULL_TRACER
from repro_torch.serving.engine import Request, SlotsFull
from repro_torch.serving.pages import PageTable
from repro_torch.serving.speculative import spec_exact_reason


def _leaves(tree) -> list:
    """The tensors of a cache (nested dicts and lists), in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _paths(tree, path=()) -> list:
    """The key path of each leaf, in :func:`_leaves`' order."""
    if isinstance(tree, dict):
        return [p for k in tree for p in _paths(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _paths(v, path + (i,))]
    return [path]


def _rebuild(tree, leaves):
    """``tree``'s structure with the tensors of ``leaves`` (an iterator)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, leaves) for v in tree]
    return next(leaves)


def _lane_mask(mask: torch.Tensor, ndim: int, ba: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[ba] = mask.shape[0]
    return mask.view(shape)


class PagedServingEngine:
    """Continuous-batching engine over a paged KV pool.

    ``max_ctx`` is the per-request context bound (prompt + generation);
    ``pool_pages`` bounds *total* tokens in flight across all lanes
    (default: enough for every lane at full context — no preemption unless
    oversubscribed on purpose).
    """

    def __init__(self, model: Model, params: Any, *, decode_batch: int,
                 max_ctx: int, page_size: int = 8, pool_pages: int | None = None,
                 chunk: int = 8, chunks_per_step: int | None = None,
                 admit_cap: int | None = None,
                 defrag_threshold: float | None = None, provider=None,
                 plan: ExecutionPlan | None = None,
                 record_logits: bool = False,
                 draft_model: Model | None = None, draft_params: Any = None,
                 spec_k: int = 0):
        cfg = model.cfg
        if cfg.family == "audio" or cfg.encoder_layers:
            raise ValueError(f"paged serving does not support {cfg.family!r}")
        if cfg.vision_tokens:
            raise ValueError("paged serving does not support vision-prefix archs")
        if max_ctx % page_size:
            raise ValueError("max_ctx must be a multiple of page_size")
        self.spec_k = int(spec_k)
        self._spec = draft_model is not None and self.spec_k > 0
        if self._spec:
            for c in (cfg, draft_model.cfg):
                reason = spec_exact_reason(c)
                if reason:
                    raise ValueError(
                        f"speculative decoding unsupported for {c.name}: {reason}")
            if draft_params is None:
                raise ValueError("speculative decoding needs draft_params")
            if draft_model.cfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft and target must share a vocabulary")
            if self.spec_k + 1 > max_ctx:
                raise ValueError("spec_k + 1 exceeds max_ctx")
        self.draft_model = draft_model if self._spec else None
        self.draft_params = draft_params if self._spec else None
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = model.device
        self.decode_batch = decode_batch
        self.max_ctx = max_ctx
        self.page_size = page_size
        self.chunk = max(1, min(chunk, max_ctx))
        self.chunks_per_step = (chunks_per_step if chunks_per_step is not None
                                else max(2, decode_batch // 4))
        self.admit_cap = admit_cap if admit_cap is not None else 2 * decode_batch
        self.pages_per_seq = max_ctx // page_size
        if pool_pages is None:
            pool_pages = decode_batch * self.pages_per_seq + 1  # +1: trash
        self.table = PageTable(pool_pages, page_size)
        if defrag_threshold is not None and not 0.0 < defrag_threshold < 1.0:
            raise ValueError("defrag_threshold must lie in (0, 1)")
        self.defrag_threshold = defrag_threshold
        self.record_logits = record_logits

        # ---- cache leaf classification (shapes on "meta", no storage) ------
        # batch axis: where (2, max_ctx) and (3, max_ctx) differ; length axis
        # (paged leaves only): where (2, max_ctx) and (2, max_ctx - 1) differ.
        # A ring cache shorter than max_ctx has no length axis: a lane leaf.
        probe_a = model.init_cache(2, max_ctx, device="meta")
        lb_ = _leaves(model.init_cache(3, max_ctx, device="meta"))
        lc_ = _leaves(model.init_cache(2, max_ctx - 1, device="meta"))
        self._template = probe_a
        self._info: list[tuple[int, int | None]] = []
        for a, b, c in zip(_leaves(probe_a), lb_, lc_):
            ba = next(i for i in range(a.dim()) if a.shape[i] != b.shape[i])
            diff = [i for i in range(a.dim()) if a.shape[i] != c.shape[i]]
            self._info.append((ba, diff[0] if diff else None))
        paths = _paths(probe_a)
        self._t_idx = paths.index(("t",))
        # lane leaves the model writes in place (attention ring caches):
        # a batched decode or verify runs on a clone of them
        self._in_place = [la is None and path[-1] in ("k", "v")
                          for path, (_, la) in zip(paths, self._info)]

        # ---- draft model cache (dense lane strips; the draft is small) ----
        self._draft_ctx: dict[int, int] = {}      # uid -> draft rows in sync
        if self._spec:
            dm = draft_model
            dp_a = dm.init_cache(2, max_ctx, device="meta")
            dl_b = _leaves(dm.init_cache(3, max_ctx, device="meta"))
            self._draft_template = dp_a
            self._draft_info = [
                next(i for i in range(a.dim()) if a.shape[i] != b.shape[i])
                for a, b in zip(_leaves(dp_a), dl_b)]
            self._draft_t_idx = _paths(dp_a).index(("t",))
            self._draft_leaves = _leaves(dm.init_cache(decode_batch, max_ctx))
        # worst-case page growth of one lane in one step (the admission
        # watermark reserve): a speculative burst writes spec_k+1 rows
        self._growth_pages = (-(-(self.spec_k + 1) // page_size)
                              if self._spec else 1)

        # ---- storage: paged leaves -> pool-flat, lane leaves -> dense -----
        rows = pool_pages * page_size
        self.leaves: list[torch.Tensor] = []
        for leaf, (ba, la) in zip(_leaves(model.init_cache(decode_batch, max_ctx, device="meta")),
                                  self._info):
            shape = list(leaf.shape)
            if la is not None:
                del shape[ba]
                shape[self._pool_axis(ba, la)] = rows
            self.leaves.append(torch.zeros(shape, dtype=leaf.dtype, device=self.device))

        # ---- host-side request state --------------------------------------
        self.waiting: deque[Request] = deque()
        self.lanes: list[Request | None] = [None] * decode_batch
        self._prefill_fifo: list[int] = []   # uids in admission order
        self._off: dict[int, int] = {}       # uid -> prefill progress (tokens)
        self._ctx: dict[int, int] = {}       # uid -> cache positions written
        self._ptoks: dict[int, list[int]] = {}   # uid -> tokens to prefill
        self._skip_emit: set[int] = set()    # resumed victims: no re-emit
        self._uid = 0
        self._chunk_lens_run: set[int] = set()
        self.last_logits: torch.Tensor | None = None
        self.chunk_logits: dict[int, np.ndarray] = {}
        self.preemptions = 0
        # speculative-decode counters + event feed
        self.spec_bursts = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_committed = 0
        self._spec_events: list[dict] = []
        self.defrags = 0                     # pool compactions actually applied
        self.prefill_true_tokens = 0
        self.prefill_padded_tokens = 0       # == true: chunked prefill pads nothing

        # observability: the owner rebinds these; the no-op default keeps
        # the hot path at one attribute check.  trace_compute gates the
        # spans around the model calls.
        self.tracer = NULL_TRACER
        self.trace_track = "engine"
        self.trace_compute = True

        # ---- execution plan ------------------------------------------------
        self.provider = provider
        self.plan = plan
        self.replans = 0
        self.plan_history: list[tuple[int, int]] = []
        self._steps = 0
        if provider is not None and getattr(provider, "pipeline", None) is not None:
            if self.plan is None:
                self.plan = plan_serving_paged(
                    cfg, provider.pipeline, decode_batch=decode_batch,
                    page_size=page_size, pages_per_seq=self.pages_per_seq,
                    chunk_lens=tuple(range(1, self.chunk + 1)),
                    spec_k=self.spec_k if self._spec else 0,
                    draft_cfg=draft_model.cfg if self._spec else None)
            provider.plan = self.plan

    # ------------------------------------------------------------------
    # model calls on the pool
    # ------------------------------------------------------------------
    @staticmethod
    def _pool_axis(ba: int, la: int) -> int:
        """Length axis of the pool-flat leaf (dense leaf minus batch axis)."""
        return la - 1 if ba < la else la

    def _span(self, name: str, **attrs):
        if self.tracer.enabled and self.trace_compute:
            return self.tracer.span(name, self.trace_track, **attrs)
        return contextlib.nullcontext()

    def _gather(self, leaf: torch.Tensor, idx: torch.Tensor, ba: int, la: int) -> torch.Tensor:
        """Pool leaf + (B, T) pool rows -> a dense (B, ..., T, ...) copy laid
        out as the slot engine's cache leaf."""
        pa = self._pool_axis(ba, la)
        taken = leaf.index_select(pa, idx.reshape(-1)).unflatten(pa, tuple(idx.shape))
        return taken.movedim((pa, pa + 1), (ba, la)).contiguous()

    def _scatter(self, leaf: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
                 ba: int, la: int) -> None:
        """Write ``vals`` (n, *rest) into pool rows ``rows`` (n,) of ``leaf``."""
        leaf.movedim(self._pool_axis(ba, la), 0).index_copy_(0, rows, vals.to(leaf.dtype))

    def _batched_view(self, idx: torch.Tensor) -> dict:
        """The cache a batched decode or verify runs on: every lane's pages
        gathered, the lane leaves it writes in place cloned."""
        dense = [(leaf.clone() if in_place else leaf) if la is None
                 else self._gather(leaf, idx, ba, la)
                 for leaf, (ba, la), in_place in zip(self.leaves, self._info, self._in_place)]
        return _rebuild(self._template, iter(dense))

    def _decode(self, toks, idx, rows, active) -> torch.Tensor:
        cache = self._batched_view(idx)
        pos = cache["t"].long()
        logits, new_cache = self.model.decode_step(self.params, cache, toks,
                                                   provider=self.provider)
        lanes = torch.arange(self.decode_batch, device=self.device)
        for i, (leaf, new, (ba, la)) in enumerate(zip(self.leaves, _leaves(new_cache),
                                                      self._info)):
            if la is None:
                self.leaves[i] = torch.where(_lane_mask(active, leaf.dim(), ba),
                                             new.to(leaf.dtype), leaf)
            else:
                # inactive lanes carry rows == 0: garbage lands on the trash
                # page, which nothing ever attends to
                dn = new.movedim((ba, la), (0, 1))          # (B, T, *rest)
                self._scatter(leaf, rows, dn[lanes, pos], ba, la)
        return logits

    def _chunk(self, toks, off: int, lane: int, idx_lane) -> torch.Tensor:
        c = toks.shape[1]
        view = [leaf.narrow(ba, lane, 1) if la is None
                else self._gather(leaf, idx_lane[None], ba, la)
                for leaf, (ba, la) in zip(self.leaves, self._info)]
        cache = _rebuild(self._template, iter(view))
        logits, new_cache = self.model.prefill_chunk(self.params, cache, toks, off,
                                                     provider=self.provider)
        for leaf, v, new, (ba, la) in zip(self.leaves, view, _leaves(new_cache), self._info):
            if la is None:
                if new is not v:          # fresh state (recurrent layers, t)
                    v.copy_(new)
            else:
                dn = new.movedim((ba, la), (0, 1))[0]      # (T, *rest)
                self._scatter(leaf, idx_lane[off:off + c], dn[off:off + c], ba, la)
        return logits[0]

    def _reset(self, lane: int) -> None:
        """Zero one lane's strip of every lane leaf (fresh recurrent / ring
        state for a new occupant; paged rows need no reset: the causal masks
        never read beyond what a request has written)."""
        for leaf, (ba, la) in zip(self.leaves, self._info):
            if la is None:
                leaf.narrow(ba, lane, 1).zero_()

    def _verify(self, toks, offs, idx, active) -> torch.Tensor:
        """Batched speculative verify: toks (B, K+1) at per-lane cache
        offsets ``offs``, one call for all lanes."""
        cache = self._batched_view(idx)
        logits, new_cache = self.model.verify_step(self.params, cache, toks, offs,
                                                   provider=self.provider)
        b, c = toks.shape
        posn = offs[:, None] + torch.arange(c, device=self.device)   # (B, C)
        rows = idx.gather(1, posn).reshape(-1)                        # (B*C,)
        lanes = torch.arange(b, device=self.device)[:, None]
        for i, (leaf, new, (ba, la)) in enumerate(zip(self.leaves, _leaves(new_cache),
                                                      self._info)):
            if la is None:
                self.leaves[i] = torch.where(_lane_mask(active, leaf.dim(), ba),
                                             new.to(leaf.dtype), leaf)
            else:
                # inactive lanes carry idx == 0: their rows land on the
                # trash page (duplicate writes race harmlessly there)
                dn = new.movedim((ba, la), (0, 1))               # (B, T, *rest)
                self._scatter(leaf, rows, dn[lanes, posn].flatten(0, 1), ba, la)
        return logits

    def _draft_burst(self, toks, active) -> torch.Tensor:
        """K+1 greedy draft decode steps: proposals d1..dK plus one step that
        only ingests dK's KV row, so an all-accept burst leaves the draft
        cache caught up.  Runs on a clone (decode writes a row of every
        lane); lanes that did not speculate keep their strips."""
        clones = [leaf.clone() for leaf in self._draft_leaves]
        cache = _rebuild(self._draft_template, iter(clones))
        props, tok = [], toks
        for _ in range(self.spec_k + 1):
            logits, cache = self.draft_model.decode_step(self.draft_params, cache, tok,
                                                         provider=self.provider)
            tok = torch.argmax(logits, dim=-1)
            props.append(tok)
        self._draft_leaves = [
            torch.where(_lane_mask(active, leaf.dim(), ba), new.to(leaf.dtype), leaf)
            for leaf, new, ba in zip(self._draft_leaves, _leaves(cache), self._draft_info)]
        return torch.stack(props)                                   # (K+1, B)

    def _draft_chunk(self, toks, off: int, lane: int) -> None:
        """Mirror one target prefill chunk into the draft's dense cache, so
        bursts start from committed state."""
        view = [leaf.narrow(ba, lane, 1)
                for leaf, ba in zip(self._draft_leaves, self._draft_info)]
        cache = _rebuild(self._draft_template, iter(view))
        _, new_cache = self.draft_model.prefill_chunk(self.draft_params, cache, toks, off,
                                                      provider=self.provider)
        for v, new in zip(view, _leaves(new_cache)):
            if new is not v:
                v.copy_(new)

    def _draft_reset(self, lane: int) -> None:
        for leaf, ba in zip(self._draft_leaves, self._draft_info):
            leaf.narrow(ba, lane, 1).zero_()

    def _tensor(self, a, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(a).to(device=self.device, dtype=dtype)

    # ------------------------------------------------------------------
    # admission surfaces (router-compatible)
    # ------------------------------------------------------------------
    @property
    def active(self) -> dict[int, Request]:
        """All in-flight requests (waiting + laned), keyed by uid — truthy
        whenever the engine has work, mirroring the slot engine contract."""
        out = {r.uid: r for r in self.lanes if r is not None}
        out.update({r.uid: r for r in self.waiting})
        return out

    @property
    def in_flight(self) -> int:
        return len(self.waiting) + sum(1 for r in self.lanes if r is not None)

    @property
    def free_slots(self) -> int:
        """Admission headroom (queue slots, not lanes: lanes turn over every
        iteration, so admission capacity is what routers should see)."""
        return max(0, self.admit_cap - self.in_flight)

    def utilization(self) -> float:
        """Fraction of the page pool held — the real memory pressure gauge."""
        return self.table.used_pages / self.table.usable_pages

    def kv_used_tokens(self) -> int:
        return sum(self._ctx.get(r.uid, 0)
                   for r in self.lanes if r is not None)

    def kv_capacity_tokens(self) -> int:
        return self.table.capacity_tokens

    def bucket_for(self, prompt_len: int) -> int:
        """Chunk length a prompt of this length mostly runs at (demand
        trackers and routers key on it; no padding is implied)."""
        return min(max(prompt_len, 1), self.chunk)

    @property
    def prefill_trace_count(self) -> int:
        """Distinct chunk lengths run — bounded by ``chunk``."""
        return len(self._chunk_lens_run)

    # ------------------------------------------------------------------
    # request admission
    # ------------------------------------------------------------------
    def add_request(self, prompt: list[int], max_new_tokens: int = 16,
                    eos_id: int | None = None, *,
                    speculative: bool | None = None,
                    request_class: str = "") -> Request:
        """Enqueue a request; prefill happens chunk by chunk inside
        :meth:`step` (admission is O(1)).

        ``speculative=None`` follows the engine default (speculate whenever
        a draft model is configured); an explicit False pins the request to
        plain decode.

        Raises :class:`SlotsFull` at the admission cap and ``ValueError``
        for a request the pool can never hold.
        """
        n = len(prompt)
        if n < 1:
            raise ValueError("empty prompt")
        total = n + max(max_new_tokens, 0)
        if total > self.max_ctx:
            raise ValueError(
                f"prompt {n} + max_new_tokens {max_new_tokens} exceeds "
                f"max_ctx {self.max_ctx} (per-request max_len)")
        if self.table.pages_for(total) > self.table.usable_pages:
            raise ValueError(
                f"request needs {self.table.pages_for(total)} pages; pool "
                f"has {self.table.usable_pages}")
        if self.in_flight >= self.admit_cap:
            raise SlotsFull(
                f"admission cap {self.admit_cap} reached")
        self._uid += 1
        req = Request(self._uid, list(prompt), max_new_tokens, eos_id,
                      speculative=(self._spec if speculative is None
                                   else bool(speculative) and self._spec),
                      request_class=request_class)
        self.waiting.append(req)
        self._ptoks[req.uid] = list(prompt)
        return req

    # ------------------------------------------------------------------
    # scheduling (pure: both the step executor and the cost preview)
    # ------------------------------------------------------------------
    def _schedule(self) -> dict:
        """Decide this iteration's work from current state, deterministically.

        Returns admits / chunks / decode lanes / preemptions.  Page
        feasibility is *simulated* against the live table so execution
        (which allocates in the same order) can never hit
        :class:`PagesExhausted` unexpectedly.  Called by :meth:`step` right
        before executing and by :meth:`planned_work` — same state, same
        answer.
        """
        held = {uid: len(self.table.pages(uid)) for uid in self.table.holders()}
        sim_free = self.table.free_pages
        pages_for = self.table.pages_for

        # Admission gate (the vLLM watermark idiom): only admit when the
        # pool can hold the request's whole prompt on top of worst-case
        # decode growth this step.
        admits: list[tuple[Request, int]] = []
        free_lanes = [i for i, r in enumerate(self.lanes) if r is None]
        admit_free = sim_free - sum(
            self._growth_pages if (self._spec and r.speculative) else 1
            for r in self.lanes if r is not None)
        for lane, req in zip(free_lanes, self.waiting):
            need = pages_for(len(self._ptoks[req.uid]))
            if need > admit_free:
                break  # FIFO: later arrivals do not jump the page queue
            admit_free -= need
            admits.append((req, lane))

        # prefill chunks: strict FIFO, bounded per step
        prefilling: list[Request] = []
        by_uid = {r.uid: r for r in self.lanes if r is not None}
        for uid in self._prefill_fifo:
            r = by_uid.get(uid)
            if r is not None and self._off[uid] < len(self._ptoks[uid]):
                prefilling.append(r)
        prefilling.extend(r for r, _ in admits)
        chunks: list[tuple[int, int, int, bool]] = []
        draft_sync: list[int] = []           # chunk mirrors into the draft
        budget = self.chunks_per_step
        for r in prefilling:
            if budget <= 0:
                break
            off = self._off.get(r.uid, 0)
            n = len(self._ptoks[r.uid])
            # Shrink the chunk to what the pool can hold right now: a
            # partial chunk keeps a long prefill moving under page pressure
            # (chunked prefill is exact at any split point).
            cap = (held.get(r.uid, 0) + sim_free) * self.page_size - off
            c = min(self.chunk, n - off, cap)
            if c <= 0:
                continue  # no pages for even one token: skip, not stall
            need = pages_for(off + c) - held.get(r.uid, 0)
            sim_free -= max(need, 0)
            held[r.uid] = held.get(r.uid, 0) + max(need, 0)
            chunks.append((r.uid, off, c, off + c >= n))
            if self._spec and r.speculative:
                draft_sync.append(c)
            budget -= 1

        # decode lanes + page-pressure preemption (evict youngest decoders)
        chunk_uids = {c[0] for c in chunks}
        decoders = [r for r in self.lanes
                    if r is not None and r.uid not in chunk_uids
                    and self._off.get(r.uid, 0) >= len(self._ptoks[r.uid])]
        spec_set = {r.uid for r in decoders if self._spec_ready(r)}
        needs = {r.uid: pages_for(self._ctx[r.uid]
                                  + (self.spec_k + 1 if r.uid in spec_set else 1)
                                  ) - held.get(r.uid, 0)
                 for r in decoders}
        preempts: list[int] = []
        total_need = sum(max(v, 0) for v in needs.values())
        if total_need > sim_free:
            for victim in sorted(decoders, key=lambda r: -r.uid):
                preempts.append(victim.uid)
                sim_free += held.get(victim.uid, 0)
                total_need -= max(needs[victim.uid], 0)
                if total_need <= sim_free:
                    break
        decode_uids = [r.uid for r in decoders if r.uid not in preempts]
        spec_uids = [u for u in decode_uids if u in spec_set]

        # deadlock breaker: >= 2 prefilling holders, none can grow, nothing
        # decoding to release pages naturally -> evict the youngest holder
        stall_preempts: list[int] = []
        if not chunks and not decode_uids and not preempts and prefilling:
            holders = [r for r in prefilling if held.get(r.uid, 0) > 0]
            if len(holders) > 1:
                stall_preempts.append(max(h.uid for h in holders))
        return {"admits": admits, "chunks": chunks,
                "decode_uids": decode_uids, "spec_uids": spec_uids,
                "draft_sync_lens": draft_sync, "preempts": preempts,
                "stall_preempts": stall_preempts}

    def _spec_ready(self, req: Request) -> bool:
        """Can this decoding lane run a draft-then-verify burst next step?

        Pure state inspection (:meth:`planned_work`'s preview must equal
        :meth:`step`'s execution).  A lane whose draft cache fell out of
        sync — it ran plain steps near the context or token budget bound —
        stays plain: both bounds only tighten as the request ages.
        """
        if not self._spec or not req.speculative:
            return False
        ctx = self._ctx[req.uid]
        if self._draft_ctx.get(req.uid) != ctx:
            return False
        if ctx + self.spec_k + 1 > self.max_ctx:
            return False
        # fewer than 2 tokens of budget left: a burst cannot beat one
        # plain decode step (the correction token alone finishes it)
        return req.max_new_tokens - len(req.generated) >= 2

    def planned_work(self) -> dict:
        """Preview of the next :meth:`step`'s work for external cost models:
        chunk lengths to run, whether a batched decode runs, and admissions."""
        acts = self._schedule()
        plain = len(acts["decode_uids"]) - len(acts["spec_uids"])
        return {
            "chunk_lens": [c for _, _, c, _ in acts["chunks"]],
            "decode": plain > 0,
            "decode_lanes": plain,
            "spec_lanes": len(acts["spec_uids"]),
            "draft_steps": self.spec_k + 1 if acts["spec_uids"] else 0,
            "verify_len": self.spec_k + 1 if acts["spec_uids"] else 0,
            "draft_sync_lens": list(acts["draft_sync_lens"]),
            "admits": len(acts["admits"]),
            "preempts": len(acts["preempts"]) + len(acts["stall_preempts"]),
        }

    # ------------------------------------------------------------------
    # plan upkeep (the slot engine's contract)
    # ------------------------------------------------------------------
    def _maybe_replan(self) -> None:
        if self.plan is None or self.provider is None:
            return
        if self.provider.pipeline.generation() == self.plan.generation:
            return
        self.plan = self.plan.refresh(self.provider.pipeline)
        self.provider.plan = self.plan
        self.replans += 1
        if self.tracer.enabled:
            self.tracer.event("replan", self.trace_track,
                              generation=self.plan.generation,
                              replans=self.replans)

    def refresh_plan(self) -> bool:
        before = self.replans
        self._maybe_replan()
        return self.replans != before

    # ------------------------------------------------------------------
    # lifecycle: withdrawal (drain-retire support)
    # ------------------------------------------------------------------
    def withdraw_waiting(self) -> list[int]:
        """Remove and return the uids of waiting requests with no progress.

        Requests this engine accepted but never started (no chunk run, no
        token emitted) can be replayed elsewhere verbatim.  Preempted
        victims carrying generated tokens are kept.  Waiting requests hold
        no pages, so no pool cleanup is needed.
        """
        kept: deque[Request] = deque()
        out: list[int] = []
        while self.waiting:
            r = self.waiting.popleft()
            if r.generated or r.uid in self._skip_emit:
                kept.append(r)
                continue
            self._ptoks.pop(r.uid, None)
            out.append(r.uid)
        self.waiting = kept
        return out

    # ------------------------------------------------------------------
    # defragmentation
    # ------------------------------------------------------------------
    def _defrag(self) -> int:
        """Compact the page pool and replay the moves on the KV rows.

        :meth:`PageTable.defrag` rewrites the table and returns ``(src,
        dst)`` page moves whose destinations were free, so copying src rows
        over dst rows never clobbers live data.  The same rows hold the same
        values afterwards, only at new pool offsets.
        """
        moves = self.table.defrag()
        if not moves:
            return 0
        ps = self.page_size
        src = self._tensor(np.concatenate([np.arange(s * ps, (s + 1) * ps) for s, _ in moves]))
        dst = self._tensor(np.concatenate([np.arange(d * ps, (d + 1) * ps) for _, d in moves]))
        for leaf, (ba, la) in zip(self.leaves, self._info):
            if la is not None:
                pm = leaf.movedim(self._pool_axis(ba, la), 0)
                pm.index_copy_(0, dst, pm.index_select(0, src))
        self.defrags += 1
        if self.tracer.enabled:
            self.tracer.event("defrag", self.trace_track, moves=len(moves))
        return len(moves)

    # ------------------------------------------------------------------
    # the iteration
    # ------------------------------------------------------------------
    def _preempt(self, uid: int) -> None:
        """Evict a request: free pages, requeue at the FRONT of waiting with
        recompute-on-resume (re-prefill prompt + tokens so far; the pending
        token is re-fed, not re-emitted)."""
        lane = next(i for i, r in enumerate(self.lanes)
                    if r is not None and r.uid == uid)
        req = self.lanes[lane]
        self.lanes[lane] = None
        self.table.release(uid)
        if uid in self._prefill_fifo:
            self._prefill_fifo.remove(uid)
        self._off.pop(uid, None)
        self._ctx.pop(uid, None)
        self._draft_ctx.pop(uid, None)
        if req.generated:
            self._ptoks[uid] = req.prompt + req.generated[:-1]
            self._skip_emit.add(uid)
        else:
            self._ptoks[uid] = list(req.prompt)
        self.waiting.appendleft(req)
        self.preemptions += 1
        if self.tracer.enabled:
            self.tracer.event("preempt", self.trace_track, uid=uid,
                              generated=len(req.generated))

    def _release(self, req: Request) -> None:
        uid = req.uid
        lane = next(i for i, r in enumerate(self.lanes)
                    if r is not None and r.uid == uid)
        self.lanes[lane] = None
        self.table.release(uid)
        if uid in self._prefill_fifo:
            self._prefill_fifo.remove(uid)
        self._off.pop(uid, None)
        self._ctx.pop(uid, None)
        self._draft_ctx.pop(uid, None)
        self._ptoks.pop(uid, None)
        self._skip_emit.discard(uid)

    def drain_spec_events(self) -> list[dict]:
        """Hand off accumulated per-burst speculative events (uid, class,
        proposed, accepted, committed)."""
        out, self._spec_events = self._spec_events, []
        return out

    def _spec_step(self, spec_uids: list[int]) -> list[Request]:
        """One draft-then-verify burst over the speculating lanes.

        The draft proposes K tokens (K+1 decode steps), the target verifies
        all lanes in ONE batched ``verify_step``, and greedy acceptance
        commits the longest agreeing prefix plus the target's correction
        token — bit-exact against plain greedy decode.  Rejected cache rows
        need no explicit rollback: the host-side ``_ctx`` is the truth, the
        decode-position leaf is rewritten from it below, and stale rows are
        masked until later writes overwrite them in order.

        Two host pulls per burst whatever the lane count: the proposals and
        the verify argmax.
        """
        K, B = self.spec_k, self.decode_batch
        toks = np.zeros(B, np.int64)
        offs = np.zeros(B, np.int64)
        idx = np.zeros((B, self.max_ctx), np.int64)
        active = np.zeros(B, bool)
        spec_lanes: list[tuple[int, Request]] = []
        for lane, req in enumerate(self.lanes):
            if req is None or req.uid not in spec_uids:
                continue
            uid, ctx = req.uid, self._ctx[req.uid]
            self.table.ensure(uid, ctx + K + 1)   # simulation guaranteed it
            toks[lane] = req.generated[-1]
            offs[lane] = ctx
            idx[lane] = self.table.flat_rows(uid, self.max_ctx)
            active[lane] = True
            spec_lanes.append((lane, req))

        # Rebuild the draft's decode positions from host truth: the leaf
        # still carries the previous burst's full K+1 advance, which the
        # acceptance decision may have partially rolled back.
        dt = np.zeros(B, np.int32)
        for lane, req in spec_lanes:
            dt[lane] = self._draft_ctx[req.uid]
        self._draft_leaves[self._draft_t_idx] = self._tensor(dt, torch.int32)
        toks_d, active_d = self._tensor(toks), self._tensor(active, torch.bool)
        with self._span("draft_burst", lanes=len(spec_lanes), k=K):
            props = self._draft_burst(toks_d, active_d)
        props_host = props.cpu().numpy()           # (K+1, B); row K is ingest-only

        vt = np.zeros((B, K + 1), np.int64)
        vt[:, 0] = toks                            # pending token first
        vt[:, 1:] = props_host[:K].T
        with self._span("verify", lanes=len(spec_lanes), k=K):
            logits = self._verify(self._tensor(vt), self._tensor(offs), self._tensor(idx),
                                  active_d)
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()   # (B, K+1)

        finished: list[Request] = []
        for lane, req in spec_lanes:
            uid = req.uid
            d = props_host[:K, lane]
            g = greedy[lane]
            a = 0
            while a < K and int(g[a]) == int(d[a]):
                a += 1
            done = False
            committed = 0
            for tok in [int(x) for x in d[:a]] + [int(g[a])]:
                req.generated.append(tok)
                committed += 1
                if (req.eos_id is not None and tok == req.eos_id) or \
                        len(req.generated) >= req.max_new_tokens:
                    done = True
                    break
            self.spec_bursts += 1
            self.spec_proposed += K
            self.spec_accepted += a
            self.spec_committed += committed
            new_ctx = len(req.prompt) + len(req.generated) - 1
            self._ctx[uid] = new_ctx
            self._draft_ctx[uid] = new_ctx
            self._spec_events.append({
                "uid": uid, "request_class": req.request_class,
                "proposed": K, "accepted": a, "committed": committed})
            if self.tracer.enabled:
                self.tracer.event("spec_burst", self.trace_track, uid=uid,
                                  accepted=a, proposed=K, committed=committed,
                                  request_class=req.request_class)
            if done:
                req.done = True
                finished.append(req)
                self._release(req)

        # Wholesale decode-position rollback: overwrite the t leaf from the
        # host _ctx map (verify advanced every speculating lane by K+1; the
        # accepted prefix may be shorter).  Non-speculating lanes keep their
        # exact current positions.
        t_host = np.zeros(B, np.int32)
        for lane, req in enumerate(self.lanes):
            if req is not None and req.uid in self._ctx:
                t_host[lane] = self._ctx[req.uid]
        self.leaves[self._t_idx] = self._tensor(t_host, torch.int32)
        return finished

    def step(self) -> list[Request]:
        """One iteration: admit, one prefill chunk each (bounded), one
        batched decode over decoding lanes.  Returns finished requests."""
        self._maybe_replan()
        if not self.in_flight:
            return []
        # Step boundary is the one safe instant to move pages: no chunk or
        # decode is mid-flight, so the table and the pool rows agree.
        if self.defrag_threshold is not None and \
                self.table.fragmentation() > self.defrag_threshold:
            self._defrag()
        self._steps += 1
        if self.plan is not None and (
                not self.plan_history
                or self.plan_history[-1][1] != self.plan.generation):
            self.plan_history.append((self._steps, self.plan.generation))

        acts = self._schedule()
        if self.tracer.enabled:
            self.tracer.event(
                "schedule", self.trace_track, step=self._steps,
                admits=len(acts["admits"]), chunks=len(acts["chunks"]),
                decode_lanes=len(acts["decode_uids"]),
                spec_lanes=len(acts["spec_uids"]),
                preempts=len(acts["preempts"]) + len(acts["stall_preempts"]),
                waiting=len(self.waiting))
        finished: list[Request] = []

        for req, lane in acts["admits"]:
            if not self.waiting or self.waiting[0] is not req:
                raise RuntimeError("admission out of FIFO order")
            self.waiting.popleft()
            self.lanes[lane] = req
            self._prefill_fifo.append(req.uid)
            self._off[req.uid] = 0
            self._ctx[req.uid] = 0
            self._reset(lane)
            if self._spec and req.speculative:
                self._draft_ctx[req.uid] = 0
                self._draft_reset(lane)

        # final-chunk emissions are batched into one argmax + one host pull
        # at the end of the loop
        pending_finals: list[tuple[int, Request, torch.Tensor]] = []
        for uid, off, c, final in acts["chunks"]:
            self.table.ensure(uid, off + c)   # simulation guarantees success
            req = next(r for r in self.lanes if r is not None and r.uid == uid)
            lane = self.lanes.index(req)
            toks = self._tensor([self._ptoks[uid][off:off + c]])
            idx_lane = self._tensor(self.table.flat_rows(uid, self.max_ctx))
            self._chunk_lens_run.add(c)
            with self._span("chunk", uid=uid, len=c, final=final):
                logits = self._chunk(toks, off, lane, idx_lane)
            if self._spec and req.speculative:
                with self._span("draft_sync", uid=uid, len=c):
                    self._draft_chunk(toks, off, lane)
                self._draft_ctx[uid] = off + c
            self._off[uid] = off + c
            self._ctx[uid] = off + c
            self.prefill_true_tokens += c
            self.prefill_padded_tokens += c   # exact-length: zero waste
            if final:
                if uid in self._skip_emit:
                    self._skip_emit.discard(uid)   # resume: token already held
                else:
                    pending_finals.append((uid, req, logits))

        if pending_finals:
            first = torch.argmax(torch.stack([lg for _, _, lg in pending_finals]),
                                 dim=-1).tolist()
            for (uid, req, logits), tok in zip(pending_finals, first):
                if self.record_logits:
                    self.chunk_logits[uid] = logits.float().cpu().numpy()
                req.generated.append(tok)
                if req.max_new_tokens <= 0 or (
                        req.eos_id is not None and tok == req.eos_id) or \
                        len(req.generated) >= req.max_new_tokens:
                    req.done = True
                    finished.append(req)
                    self._release(req)

        for uid in acts["preempts"] + acts["stall_preempts"]:
            self._preempt(uid)

        if acts["spec_uids"]:
            finished.extend(self._spec_step(acts["spec_uids"]))

        spec_set = set(acts["spec_uids"])
        decode_uids = [u for u in acts["decode_uids"] if u not in spec_set]
        if decode_uids:
            B = self.decode_batch
            toks = np.zeros(B, np.int64)
            idx = np.zeros((B, self.max_ctx), np.int64)
            rows = np.zeros(B, np.int64)
            active = np.zeros(B, bool)
            lanes_decoding = []
            for lane, req in enumerate(self.lanes):
                if req is None or req.uid not in decode_uids:
                    continue
                uid, ctx = req.uid, self._ctx[req.uid]
                self.table.ensure(uid, ctx + 1)
                pages = self.table.pages(uid)
                toks[lane] = req.generated[-1]
                idx[lane] = self.table.flat_rows(uid, self.max_ctx)
                rows[lane] = (pages[ctx // self.page_size] * self.page_size
                              + ctx % self.page_size)
                active[lane] = True
                lanes_decoding.append((lane, req))
            with self._span("decode", lanes=len(lanes_decoding)):
                logits = self._decode(self._tensor(toks), self._tensor(idx),
                                      self._tensor(rows), self._tensor(active, torch.bool))
            self.last_logits = logits
            nxt = torch.argmax(logits, dim=-1).tolist()   # one host transfer
            for lane, req in lanes_decoding:
                tok = int(nxt[lane])
                req.generated.append(tok)
                self._ctx[req.uid] += 1
                if (req.eos_id is not None and tok == req.eos_id) or \
                        len(req.generated) >= req.max_new_tokens:
                    req.done = True
                    finished.append(req)
                    self._release(req)
        return finished

    def run_to_completion(self, max_steps: int = 4096) -> None:
        for _ in range(max_steps):
            if not self.in_flight:
                break
            self.step()
