"""Model facade of the port, ported from the reference's ``models/model.py``
for all six families: dense, moe, vlm, ssm, hybrid and encdec.

``Model(cfg, device=None, *, plan=None)`` runs on ``cuda`` unless the
caller passes ``device="cpu"``; asking for CUDA where there is none
raises.  ``plan`` (default ``get_plan("futurized")``) is the training
step's plan: its remat policy, bf16 boundaries and, on a mesh, where each
logical axis lands.

On a mesh the params (and batch, inputs or cache) are DTensors: every
family runs with the mesh of its params active (``launch.mesh.use``),
plain tensors such as positions taken as replicated, the plan's gather
points and constraints at the reference's sites, and each kernel on each
rank's shards (``layers.on_shards``).  Without a mesh the serving paths
take no plan, so their constraints cost nothing.  A mesh on another
device type than the model's raises.

    param_specs() / init(seed) / compute_params(params) / init_compute(seed)
    abstract_params() / batch_specs(cell) / prefill_specs(cell) / decode_specs(cell)
                                                    dry-run stand-ins, no data
    loss(params, batch)                             train objective
    prefill(params, inputs, cache_len, valid_len)   → (last logits, cache)
    decode(params, cache, token)                    → (logits, new cache)
    cache_specs(batch, cache_len, enc_len) / cache_axes() / init_cache(...)
    decode_paged(params, cache, token)              → (logits, new cache)
    paged_cache_specs(num_pages, page_size, max_batch, max_pages_per_req)
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.dist.plan import ShardingPlan, get_plan
from repro_torch.models import encdec, hybrid, ssm_lm, transformer
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import params as P
from repro_torch.models.params import ParamSpec, TensorSpec, init_params

Params = Dict[str, torch.Tensor]

# family → (its module, its param specs)
_FAMILIES = {
    "dense": (transformer, transformer.decoder_param_specs),
    "moe": (transformer, transformer.decoder_param_specs),
    "vlm": (transformer, transformer.decoder_param_specs),
    "ssm": (ssm_lm, ssm_lm.lm_param_specs),
    "hybrid": (hybrid, hybrid.hybrid_param_specs),
    "encdec": (encdec, encdec.encdec_param_specs),
}


def param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """The param specs of ``cfg``'s family; a family the port does not
    know raises ``NotImplementedError`` naming it."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported (ported: {sorted(_FAMILIES)})")
    return _FAMILIES[cfg.family][1](cfg)


class Model:
    def __init__(self, cfg: ModelConfig,
                 device: Optional[Union[str, torch.device]] = None, *,
                 plan: Optional[ShardingPlan] = None):
        self._specs = param_specs(cfg)
        self._m = _FAMILIES[cfg.family][0]
        self.cfg = cfg
        self.plan = plan if plan is not None else get_plan("futurized")
        self.device = resolve_device(device)

    # ---------------------------------------------------------------- params
    def param_specs(self) -> Dict[str, ParamSpec]:
        return self._specs

    def init(self, seed: int = 0) -> Params:
        """Random params on the model's device (fp32 masters)."""
        return init_params(self._specs, seed, self.device)

    def compute_params(self, params: Params) -> Params:
        return transformer.compute_params(self.cfg, params)

    def init_compute(self, seed: int = 0) -> Params:
        """The serving params, ``compute_params(init(seed))`` bit for bit,
        made one tensor at a time: each is drawn in fp32 on the model's
        device and cast at once, so the fp32 masters never exist together
        (deepseek_moe_16b: 65.5 GB of fp32 masters beside a 32.8 GB bf16
        copy would not fit one 80 GB card)."""
        params = init_params(self._specs, seed, self.device,
                             convert=functools.partial(transformer.cast_param, self.cfg))
        return self.compute_params(params)

    def abstract_params(self, device="meta", dtype: Optional[torch.dtype] = None
                        ) -> Params:
        """The params as stand-ins without data (meta tensors, or fake ones
        under ``FakeTensorMode``): the dry run's."""
        return P.abstract_params(self._specs, device, dtype)

    # ----------------------------------------------------------------- train
    def loss(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The train objective on ``batch`` (its fields on the model's
        device: ``tokens``, and the vlm family's ``patches`` or the encdec
        family's ``enc``): next-token cross-entropy, plus
        ``router_aux_weight`` times the MoE aux loss for the moe family.
        DTensor params run on their mesh (see the module doc)."""
        with self._on_mesh(params):
            return self._m.loss_fn(self.cfg, self.plan, params, batch)

    def mesh_of(self, params: Params) -> Optional[Any]:
        """The mesh of DTensor params (None for plain ones); a mesh on
        another device type than the model's raises."""
        for v in params.values():
            if isinstance(v, DTensor):
                mesh = v.device_mesh
                if mesh.device_type != self.device.type:
                    raise ValueError(f"a {mesh.device_type} mesh under a model on "
                                     f"{self.device}")
                return mesh
        return None

    @contextlib.contextmanager
    def _on_mesh(self, params: Params) -> Iterator[Optional[ShardingPlan]]:
        """The block runs with the params' mesh active and plain tensors
        taken as replicated; yields the serving paths' plan (None without
        a mesh)."""
        mesh = self.mesh_of(params)
        if mesh is None:
            yield None
            return
        with mesh_mod.use(mesh), mesh_mod.replicating():
            yield self.plan

    def batch_axes(self) -> Dict[str, Tuple]:
        """Logical axes of each training-batch field."""
        ax = {"tokens": ("batch", "seq")}
        if self.cfg.family == "vlm":
            ax["patches"] = ("batch", "seq", None)
        if self.cfg.family == "encdec":
            ax["enc"] = ("batch", "seq", None)
        return ax

    def cache_axes(self) -> Dict[str, Tuple]:
        """Logical axes of each field of the family's decode cache."""
        return self._m.cache_axes(self.cfg)

    # ------------------------------------------------------- dry-run inputs
    def _inputs(self, B: int, S: int, n_tokens: int, device) -> Dict[str, torch.Tensor]:
        """``tokens`` (B, n_tokens) int32, and the vlm family's ``patches``
        (B, n_patches, D) or the encdec family's ``enc`` (B, S, D)."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        out = {"tokens": torch.empty((B, n_tokens), dtype=torch.int32, device=device)}
        if cfg.family == "vlm":
            out["patches"] = torch.empty((B, cfg.n_patches, cfg.d_model), dtype=dt,
                                         device=device)
        if cfg.family == "encdec":
            out["enc"] = torch.empty((B, S, cfg.d_model), dtype=dt, device=device)
        return out

    def batch_specs(self, cell: ShapeCell, device="meta") -> Dict[str, torch.Tensor]:
        """A training batch of a shape cell as stand-ins without data
        (``tokens`` one longer than the cell's sequence)."""
        return self._inputs(cell.global_batch, cell.seq_len, cell.seq_len + 1, device)

    def prefill_specs(self, cell: ShapeCell, device="meta") -> Dict[str, torch.Tensor]:
        """A prefill's inputs of a shape cell as stand-ins without data."""
        return self._inputs(cell.global_batch, cell.seq_len, cell.seq_len, device)

    def decode_specs(self, cell: ShapeCell, device="meta"
                     ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """(the cache, the token) of a decode cell as stand-ins: one new
        token against a cache of ``cell.seq_len`` (the encdec family's
        cross-attention cache as long)."""
        B, S = cell.global_batch, cell.seq_len
        cache = {k: torch.empty(s.shape, dtype=s.dtype, device=device)
                 for k, s in self.cache_specs(B, S, enc_len=S).items()}
        return cache, torch.empty((B, 1), dtype=torch.int32, device=device)

    # ----------------------------------------------------------------- serve
    def prefill(self, params: Params, inputs: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None,
                valid_len: Optional[torch.Tensor] = None):
        """``inputs``: ``tokens``, and the vlm family's ``patches`` or the
        encdec family's ``enc`` (the encoder's frames).  ``cache_len``
        sizes the KV cache of the decoder families (the SSM state and the
        hybrid's ring do not grow with it).  ``valid_len`` supports
        right-padded prompts (the serve engine's bucketed admission):
        dense, moe and vlm families only, as in the reference."""
        with self._on_mesh(params) as plan:
            if self._m is transformer:
                return transformer.prefill(self.cfg, params, inputs["tokens"],
                                           cache_len=cache_len, valid_len=valid_len,
                                           patches=inputs.get("patches"), plan=plan)
            if valid_len is not None:
                raise ValueError(f"family {self.cfg.family!r} prefills at the exact "
                                 f"prompt length (no valid_len)")
            if self._m is encdec:
                return encdec.prefill(self.cfg, params, inputs["enc"], inputs["tokens"],
                                      cache_len=cache_len, plan=plan)
            return self._m.prefill(self.cfg, params, inputs["tokens"], plan=plan)

    def decode(self, params: Params, cache: Dict[str, torch.Tensor],
               token: torch.Tensor):
        """One decode step against the family's own cache
        (:meth:`cache_specs`); the cache's tensors are updated in place."""
        with self._on_mesh(params) as plan:
            return self._m.decode_step(self.cfg, params, cache, token, plan=plan)

    def cache_specs(self, batch: int, cache_len: int,
                    enc_len: Optional[int] = None) -> Dict[str, TensorSpec]:
        """``enc_len`` sizes the encdec family's cross-attention cache
        (default ``cache_len``, as in the reference); other families
        ignore it."""
        if self._m is encdec:
            return encdec.init_cache_specs(self.cfg, batch, cache_len, enc_len or cache_len)
        return self._m.init_cache_specs(self.cfg, batch, cache_len)

    def init_cache(self, batch: int, cache_len: int,
                   enc_len: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The family's cache as zeros on the model's device."""
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for k, s in self.cache_specs(batch, cache_len, enc_len).items()}

    @property
    def supports_paged(self) -> bool:
        """Paged KV serving applies to the decoder families with a dense KV
        cache; the ssm and hybrid families carry recurrent or ring-buffer
        state, the encdec family a fixed cross-attention cache beside its
        self-attention's."""
        return self.cfg.family in ("dense", "moe", "vlm")

    def decode_paged(self, params: Params, cache: Dict[str, torch.Tensor],
                     token: torch.Tensor):
        """One decode step against a block-pool paged cache
        (:func:`repro_torch.models.transformer.paged_cache_specs` layout)."""
        if not self.supports_paged:
            raise ValueError(f"family {self.cfg.family!r} has no paged cache")
        with self._on_mesh(params) as plan:
            return transformer.decode_step_paged(self.cfg, params, cache, token, plan=plan)

    def paged_cache_specs(self, num_pages: int, page_size: int,
                          max_batch: int, max_pages_per_req: int):
        if not self.supports_paged:
            raise ValueError(f"family {self.cfg.family!r} has no paged cache")
        return transformer.paged_cache_specs(self.cfg, num_pages, page_size,
                                             max_batch, max_pages_per_req)


def build_model(cfg: ModelConfig,
                device: Optional[Union[str, torch.device]] = None, *,
                plan: Optional[ShardingPlan] = None) -> Model:
    return Model(cfg, device, plan=plan)
