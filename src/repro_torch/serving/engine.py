"""Batched serving engine: slot-based continuous batching (the counterpart of
``repro.serving.engine``).

The engine owns a fixed number of decode *slots* and one batched cache
whose ``t`` vector tracks a per-slot decode position, so sequences at
different lengths decode together in one ``decode_step``.  A new request is
prefilled (batch 1) and spliced into a free slot's rows of every cache
tensor — in place, where the reference builds a new cache; a finished
request frees its slot at once.  ``extras`` are the stub frontends' inputs
every prefill takes beside the tokens, as in the reference: encoder frames
(``frames``, whisper) or patch embeddings (``patch_embeds``, internvl2); a
2-D extra gets a batch axis at admission.  The enc-dec cache (self-KV,
``cross_k``, ``cross_v``, ``t``) is spliced like any other.

Prompts are right-padded to power-of-two buckets with ``true_len`` (exact
logits and cache positions), where padding is provably inert: attention-only
stacks, and pad lengths that fit the smallest KV cache.

**Execution plans**, as in the reference: constructed with a
:class:`~repro_torch.kernels.ops.ScheduleProvider`, the engine pre-resolves
its kernel set (the decode batch and the prefill buckets) into an
:class:`~repro_torch.core.resolution.ExecutionPlan` (:func:`plan_serving`)
and, between decode steps only, checks the resolution pipeline's
generation: when a newer schedule is published, it re-plans at the step
boundary, so a schedule published to a live registry reaches the running
server.  Nothing is traced here, so a re-plan swaps ``provider.plan`` and
nothing else.  ``plan_history`` records the (step, generation) transition
points; ``replans`` counts swaps.  Prompts of unbucketed lengths (every
prompt of a recurrent arch) are not in the plan and resolve through the
pipeline.
"""
from __future__ import annotations

import contextlib

import dataclasses

import torch

from repro_torch.core.resolution import ExecutionPlan, plan_serving
from repro_torch.models.build import Model
from repro_torch.obs import NULL_TRACER


class SlotsFull(RuntimeError):
    """Raised by :meth:`ServingEngine.add_request` when every decode slot is
    occupied — the engine-level backpressure signal."""


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int
    eos_id: int | None = None
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # speculative decode (paged engine only; the slot engine ignores both)
    speculative: bool = False
    request_class: str = ""


class ServingEngine:
    def __init__(self, model: Model, params: dict, *, slots: int, max_len: int,
                 extras: dict | None = None, provider=None, plan: ExecutionPlan | None = None,
                 prefill_buckets: bool = True):
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.extras = {k: torch.as_tensor(v, device=model.device)
                       for k, v in (extras or {}).items()}
        self.cache = model.init_cache(slots, max_len)
        self.active: dict[int, Request] = {}
        self.last_logits: torch.Tensor | None = None   # (slots, vocab), latest decode
        self._uid = 0

        cfg = model.cfg
        kinds = set(cfg.layer_kinds)
        self.prefill_buckets = (prefill_buckets and cfg.family != "audio"
                                and "R" not in kinds)
        # largest pad length that cannot corrupt a cache: ring (windowed)
        # caches hold min(window, max_len) positions and wrap beyond that
        self._bucket_cap = (max_len if (cfg.window == 0 or "L" not in kinds)
                            else min(cfg.window, max_len))
        self._prefill_lengths: set[int] = set()  # distinct padded lengths run
        self.prefill_true_tokens = 0
        self.prefill_padded_tokens = 0

        # observability: the owner rebinds these after construction; the
        # no-op default keeps the hot path at one attribute check.
        # trace_compute gates the wall-clock spans around the model calls:
        # a fleet turns it off (its tracer runs on the virtual clock, where a
        # wall-clock compute span is noise)
        self.tracer = NULL_TRACER
        self.trace_track = "engine"
        self.trace_compute = True

        # execution plan: pre-resolve the decode batch and the prefill buckets
        self.provider = provider
        self.plan = plan
        self.replans = 0
        # (step, plan generation) at each plan transition (the first step and
        # every swap): bounded by the re-plans, not by the decode steps
        self.plan_history: list[tuple[int, int]] = []
        self._steps = 0
        if provider is not None and getattr(provider, "pipeline", None) is not None:
            if self.plan is None:
                self.plan = plan_serving(
                    cfg, provider.pipeline, slots=slots, max_len=max_len,
                    prefill_lengths=self._bucket_lengths())
            provider.plan = self.plan

    # -- prefill buckets -------------------------------------------------------
    def _pad_len(self, n: int) -> int:
        """Power-of-two bucket for a prompt of n tokens (n itself when
        bucketing is off or the bucket would overflow the smallest cache)."""
        if not self.prefill_buckets or n >= self._bucket_cap:
            return n
        b = 1
        while b < n:
            b *= 2
        return min(b, self._bucket_cap)

    def _bucket_lengths(self) -> list[int]:
        """Every pad length prefill can run at (for plan coverage)."""
        if not self.prefill_buckets:
            return []
        out, b = [], 1
        while b < self._bucket_cap:
            out.append(b)
            b *= 2
        out.append(self._bucket_cap)
        return out

    @property
    def prefill_trace_count(self) -> int:
        """Distinct prefill lengths run so far (bounded by the buckets); the
        reference's name, where each length is one jit trace."""
        return len(self._prefill_lengths)

    def bucket_for(self, prompt_len: int) -> int:
        return self._pad_len(prompt_len)

    # -- admission accessors ---------------------------------------------------
    @property
    def free_slots(self) -> int:
        return self.slots - len(self.active)

    def utilization(self) -> float:
        return len(self.active) / self.slots

    # -- capacity gauges (comparable with the paged engine's) ------------------
    def kv_used_tokens(self) -> int:
        """Cache positions actually holding tokens across active slots."""
        return sum(len(r.prompt) + len(r.generated) - 1
                   for r in self.active.values())

    def kv_capacity_tokens(self) -> int:
        """Every slot reserves max_len rows whether used or not — the
        stranded-capacity denominator."""
        return self.slots * self.max_len

    # -- request admission ---------------------------------------------------
    def add_request(self, prompt: list[int], max_new_tokens: int = 16,
                    eos_id: int | None = None) -> Request:
        """Admit a request into a free slot.

        Raises :class:`SlotsFull` when the batch is full and ``ValueError``
        for a prompt the cache cannot hold.  A request the prefill already
        finishes — ``max_new_tokens <= 0``, or the prefill token is EOS — is
        returned ``done`` without ever occupying a slot.
        """
        n = len(prompt)
        if n > self.max_len:
            raise ValueError(f"prompt length {n} exceeds max_len {self.max_len}")
        free = [s for s in range(self.slots) if s not in self.active]
        if not free:
            raise SlotsFull(f"all {self.slots} decode slots are occupied")
        slot = free[0]
        self._uid += 1
        req = Request(self._uid, list(prompt), max_new_tokens, eos_id)
        pad = self._pad_len(n)
        self._prefill_lengths.add(pad)
        self.prefill_true_tokens += n
        self.prefill_padded_tokens += pad
        batch = {"tokens": torch.tensor([req.prompt + [0] * (pad - n)], dtype=torch.long,
                                        device=self.model.device)}
        for k, v in self.extras.items():
            batch[k] = v[None] if v.dim() == 2 else v   # (1, ..., D) stub inputs
        with self._compute_span("prefill", uid=req.uid, true_len=n, bucket=pad):
            logits, cache1 = self.model.prefill(self.params, batch, max_len=self.max_len,
                                                true_len=n, provider=self.provider)
            tok = int(torch.argmax(logits[0]))   # the host transfer: the step's end
        req.generated.append(tok)
        if max_new_tokens <= 0 or (eos_id is not None and tok == eos_id) or \
                len(req.generated) >= max_new_tokens:
            # the prefill token is the whole response: the slot stays free
            req.done = True
            return req
        _splice_slot(self.cache, cache1, slot)
        self.active[slot] = req
        return req

    def _compute_span(self, name: str, **attrs):
        """A wall-clock span around one model step where the tracer is on
        and ``trace_compute`` is set, else nothing.  The step's block ends
        with the host transfer of its tokens: kernels on the card run
        behind their launch, so a span closes after the step's result is on
        the host, not after its issue."""
        if self.tracer.enabled and self.trace_compute:
            return self.tracer.span(name, self.trace_track, **attrs)
        return contextlib.nullcontext()

    # -- decode ----------------------------------------------------------------
    def _maybe_replan(self) -> None:
        """Swap in a fresh plan when a publish moved the generation.

        Only ever called at a step boundary: a plan is immutable for the
        duration of one decode step.
        """
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
        """Adopt any newer published schedule generation *now* — the same
        boundary check :meth:`step` performs, without decoding a token.
        Returns True when the plan was swapped."""
        before = self.replans
        self._maybe_replan()
        return self.replans != before

    def step(self) -> list[Request]:
        """One batched decode step for all active slots; returns finished."""
        self._maybe_replan()
        if not self.active:
            return []
        self._steps += 1
        if self.plan is not None and (
                not self.plan_history
                or self.plan_history[-1][1] != self.plan.generation):
            self.plan_history.append((self._steps, self.plan.generation))
        toks = torch.zeros(self.slots, dtype=torch.long)
        for slot, req in self.active.items():
            toks[slot] = req.generated[-1]
        with self._compute_span("decode_step", active=len(self.active)):
            logits, self.cache = self.model.decode_step(
                self.params, self.cache, toks.to(self.model.device), provider=self.provider)
            nxt = torch.argmax(logits, dim=-1).tolist()   # one host transfer: the step's end
        self.last_logits = logits
        finished = []
        for slot, req in list(self.active.items()):
            tok = int(nxt[slot])
            req.generated.append(tok)
            if (req.eos_id is not None and tok == req.eos_id) or \
                    len(req.generated) >= req.max_new_tokens:
                req.done = True
                finished.append(req)
                del self.active[slot]
        return finished

    def run_to_completion(self, max_steps: int = 512) -> None:
        for _ in range(max_steps):
            if not self.active:
                break
            self.step()


def _splice_slot(full, one, slot: int) -> None:
    """Write the batch-1 cache ``one`` into row ``slot`` of every tensor of
    the batched cache ``full``, in place (the batch axis is axis 0)."""
    if isinstance(full, dict):
        for k in full:
            _splice_slot(full[k], one[k], slot)
    elif isinstance(full, list):
        for f, o in zip(full, one):
            _splice_slot(f, o, slot)
    else:
        full[slot:slot + 1] = one.to(full.dtype)
