"""Model facade (the counterpart of ``repro.models.build``).

``build_model(cfg, device)`` returns a :class:`Model` bundling init /
forward / prefill / decode_step / init_cache for one config on one device.
The device is the card (``"cuda"``) unless the caller asks for the CPU, and
asking for the card where there is none raises.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm


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

    def init(self, seed: int = 0) -> dict:
        """Random params from a ``torch.Generator`` seeded with ``seed`` on
        this model's device."""
        return lm.init_params(self.cfg, torch.Generator(device=self.device).manual_seed(seed))

    def forward(self, params: dict, batch: dict, provider=None):
        return lm.forward(params, self.cfg, batch, provider=provider)

    def prefill(self, params: dict, batch: dict, *, max_len: int, true_len: int | None = None,
                provider=None):
        return lm.prefill(params, self.cfg, batch, max_len=max_len, true_len=true_len,
                          provider=provider)

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor, provider=None):
        return lm.decode_step(params, self.cfg, cache, tokens, provider=provider)

    def init_cache(self, batch: int, max_len: int) -> dict:
        return lm.init_cache(self.cfg, batch, max_len, self.device)


def build_model(cfg: ArchConfig, device: str | torch.device = "cuda") -> Model:
    return Model(cfg=cfg, device=resolve_device(device))
