"""Multi-engine router over local engine replicas, ported from the
reference's ``serve/router.py``.

Each :class:`~repro_torch.serve.engine.Engine` replica owns its own cache
(a page pool or dense slots, as its ``ServeConfig`` and family choose),
decode continuation chain and performance counters; the router is the
only coordination point and dispatches each request to the least loaded
replica (``submitted - completed``, a local counter read — no
messages, no global queue).  Remote engines, SLO tiers, admission gating
and failover wait for the multi-locality slice.

Counters::

    /serve{router}/requests/dispatched           cumulative
    /serve{router}/dispatch/<engine-name>        cumulative per replica
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.core import counters as _counters
from repro_torch.core.future import Channel, Future
from repro_torch.models.model import Model
from repro_torch.obs import trace as _trace
from repro_torch.serve.engine import Engine, SamplingParams, ServeConfig


def default_extra_inputs(cfg, device: Optional[Union[str, torch.device]] = None
                         ) -> Dict[str, Any]:
    """Family-dependent synthetic side inputs, as the reference's: the vlm
    family's ``patches`` (zeros (1, n_patches, D) bf16), the encdec
    family's encoder frames ``enc`` (zeros (1, 64, D) bf16) with their
    count ``enc_len``; none for the other families.  The tensors are made
    on ``device`` (``cuda`` unless the caller asks for the CPU), where the
    engine lives."""
    extra: Dict[str, Any] = {}
    if cfg.family == "vlm":
        extra["patches"] = torch.zeros((1, cfg.n_patches, cfg.d_model),
                                       dtype=torch.bfloat16, device=resolve_device(device))
    if cfg.family == "encdec":
        extra["enc"] = torch.zeros((1, 64, cfg.d_model), dtype=torch.bfloat16,
                                   device=resolve_device(device))
        extra["enc_len"] = 64
    return extra


class Router:
    def __init__(self, engines: List[Engine]):
        if not engines:
            raise ValueError("router needs at least one engine")
        self.engines = list(engines)
        # request tags ("r<locality>:<seq>") stamped into every span
        self._req_seq = itertools.count(1)
        reg = _counters.default()
        self.c_dispatched = reg.counter("/serve{router}/requests/dispatched")
        self._c_dispatch = {
            e.scfg.name: reg.counter(f"/serve{{router}}/dispatch/{e.scfg.name}")
            for e in engines}

    # ------------------------------------------------------------- factory
    @classmethod
    def replicate(cls, model: Model, params: Dict[str, torch.Tensor],
                  scfg: ServeConfig, replicas: int,
                  extra_inputs: Optional[Dict[str, Any]] = None,
                  device: Optional[Union[str, torch.device]] = None) -> "Router":
        """N engine replicas named ``engine#0..N-1`` over shared params.
        The compute-dtype copy of the params is made once, here, and shared."""
        shared = model.compute_params(params)
        engines = [Engine(model, shared,
                          ServeConfig(**{**scfg.__dict__, "name": f"engine#{i}"}),
                          extra_inputs=extra_inputs, device=device)
                   for i in range(replicas)]
        return cls(engines)

    # ------------------------------------------------------------ dispatch
    def loads(self) -> List[float]:
        return [e.load() for e in self.engines]

    def pick(self) -> int:
        """Least-loaded replica (first wins ties — stable under no load)."""
        loads = self.loads()
        return loads.index(min(loads))

    def new_tag(self) -> str:
        return f"r{_trace._detect_locality()}:{next(self._req_seq)}"

    def submit(self, prompt: List[int], max_new: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               stream: Optional[Channel] = None) -> Future:
        engine = self.engines[self.pick()]
        tag = self.new_tag()
        self.c_dispatched.increment()
        self._c_dispatch[engine.scfg.name].increment()
        if _trace._enabled:
            with _trace.span("router/submit", "serve", req=tag,
                             engine=engine.scfg.name):
                return engine.submit(prompt, max_new, sampling, stream,
                                     meta={"req": tag})
        return engine.submit(prompt, max_new, sampling, stream, meta={"req": tag})

    def submit_stream(self, prompt: List[int], max_new: Optional[int] = None,
                      sampling: Optional[SamplingParams] = None
                      ) -> Tuple[Channel, Future]:
        ch: Channel = Channel()
        return ch, self.submit(prompt, max_new, sampling, stream=ch)
