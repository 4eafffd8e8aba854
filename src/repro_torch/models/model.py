"""Model facade of the port, ported from the reference's ``models/model.py``
for the dense decoder family.

``Model(cfg, device=None)`` runs on ``cuda`` unless the caller passes
``device="cpu"``; asking for CUDA where there is none raises.

    param_specs() / init(seed) / compute_params(params)
    prefill(params, inputs, cache_len, valid_len)   → (last logits, cache)
    decode_paged(params, cache, token)              → (logits, new cache)
    paged_cache_specs(num_pages, page_size, max_batch, max_pages_per_req)
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.params import ParamSpec, init_params

Params = Dict[str, torch.Tensor]


class Model:
    def __init__(self, cfg: ModelConfig,
                 device: Optional[Union[str, torch.device]] = None):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (dense only)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._specs = transformer.decoder_param_specs(cfg)

    # ---------------------------------------------------------------- params
    def param_specs(self) -> Dict[str, ParamSpec]:
        return self._specs

    def init(self, seed: int = 0) -> Params:
        """Random params on the model's device (fp32 masters)."""
        return init_params(self._specs, seed, self.device)

    def compute_params(self, params: Params) -> Params:
        return transformer.compute_params(self.cfg, params)

    # ----------------------------------------------------------------- serve
    def prefill(self, params: Params, inputs: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None,
                valid_len: Optional[torch.Tensor] = None):
        """``valid_len`` supports right-padded prompts (the serve engine's
        bucketed admission)."""
        return transformer.prefill(self.cfg, params, inputs["tokens"],
                                   cache_len=cache_len, valid_len=valid_len)

    @property
    def supports_paged(self) -> bool:
        """Paged KV serving applies to families with a dense KV cache."""
        return self.cfg.family in ("dense", "moe", "vlm")

    def decode_paged(self, params: Params, cache: Dict[str, torch.Tensor],
                     token: torch.Tensor):
        """One decode step against a block-pool paged cache
        (:func:`repro_torch.models.transformer.paged_cache_specs` layout)."""
        return transformer.decode_step_paged(self.cfg, params, cache, token)

    def paged_cache_specs(self, num_pages: int, page_size: int,
                          max_batch: int, max_pages_per_req: int):
        return transformer.paged_cache_specs(self.cfg, num_pages, page_size,
                                             max_batch, max_pages_per_req)


def build_model(cfg: ModelConfig,
                device: Optional[Union[str, torch.device]] = None) -> Model:
    return Model(cfg, device)
