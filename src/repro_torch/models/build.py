"""Model facade (the counterpart of ``repro.models.build``).

``build_model(cfg, device)`` returns a :class:`Model` bundling init /
forward / loss_fn / prefill / prefill_chunk / decode_step / verify_step /
init_cache for one config on one device: :mod:`repro_torch.models.encdec` for the
audio family (whisper), :mod:`repro_torch.models.lm` for every other.  As in
the reference, the audio model has no chunked prefill and no verify: those
two raise ``ValueError`` for it.
The device is the card (``"cuda"``) unless the caller asks for the CPU, and
asking for the card where there is none raises.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, lm
from repro_torch.tree import tree_map


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device

    @property
    def module(self):
        """The stack's module: ``encdec`` for the audio family, else ``lm``."""
        return encdec if self.cfg.family == "audio" else lm

    def init(self, seed: int = 0) -> dict:
        """Random params from a ``torch.Generator`` seeded with ``seed`` on
        this model's device."""
        return self.module.init_params(self.cfg,
                                       torch.Generator(device=self.device).manual_seed(seed))

    def abstract_params(self) -> dict:
        """The params' shapes and dtypes as ``meta`` tensors: ``init`` run
        under ``FakeTensorMode``, so nothing is drawn or stored."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            fake = self.module.init_params(self.cfg, torch.Generator(device="cpu"))
        return tree_map(lambda t: torch.empty(tuple(t.shape), dtype=t.dtype, device="meta"), fake)

    def forward(self, params: dict, batch: dict, provider=None, remat: bool = True):
        return self.module.forward(params, self.cfg, batch, remat=remat, provider=provider)

    def loss_fn(self, params: dict, batch: dict, *, remat: bool = True, provider=None):
        """(loss, {"ce", "aux"}); under autograd with ``remat`` each layer
        is recomputed in the backward."""
        return self.module.loss_fn(params, self.cfg, batch, remat=remat, provider=provider)

    def prefill(self, params: dict, batch: dict, *, max_len: int, true_len: int | None = None,
                provider=None):
        return self.module.prefill(params, self.cfg, batch, max_len=max_len, true_len=true_len,
                                   provider=provider)

    def prefill_chunk(self, params: dict, cache: dict, tokens: torch.Tensor, off: int,
                      provider=None):
        self._no_audio("chunked prefill")
        return lm.prefill_chunk(params, self.cfg, cache, tokens, off, provider=provider)

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor, provider=None):
        return self.module.decode_step(params, self.cfg, cache, tokens, provider=provider)

    def verify_step(self, params: dict, cache: dict, tokens: torch.Tensor, off, provider=None):
        self._no_audio("speculative verify")
        return lm.verify_step(params, self.cfg, cache, tokens, off, provider=provider)

    def init_cache(self, batch: int, max_len: int, device=None) -> dict:
        """A zeroed cache on this model's device, or on ``device`` (say
        ``"meta"``: shapes and dtypes with no storage)."""
        return self.module.init_cache(self.cfg, batch, max_len,
                                      self.device if device is None else torch.device(device))

    def _no_audio(self, what: str) -> None:
        if self.cfg.family == "audio":
            raise ValueError(f"the audio encoder-decoder family has no {what}")


def build_model(cfg: ArchConfig, device: str | torch.device = "cuda") -> Model:
    return Model(cfg=cfg, device=resolve_device(device))
