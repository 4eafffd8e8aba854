"""Serving engine: paged-KV continuous batching on the AMT runtime, ported
from the reference's ``serve/engine.py``.

1. **Admission** — ``submit`` enqueues the request and a prefill task is
   posted through a ``PriorityExecutor`` over the dedicated ``prefill``
   pool of the resource partitioner (falling back to the decode pool at
   ``PRIORITY_HIGH`` on unpartitioned runtimes), so admissions never steal
   decode-continuation slots.  Prompts are right-padded to power-of-two
   *buckets*; ``valid_len`` keeps logits and cache positions exact.
   Finished prefills land in a ready queue.
2. **Decode continuation chain** — each step is a scheduler task that
   integrates ready prefills into free slots (scatters the prefill KV into
   block-pool pages), runs one decode + sample step for the whole batch,
   streams each new token through the request's
   :class:`~repro_torch.core.future.Channel`, and respawns itself.
3. **Completion** — EOS / length ends a slot: pages return to the free
   list, the future resolves with the token list, the stream closes.

Sampling (temperature / top-k / top-p) runs inside the step with per-slot
parameter vectors; ``temperature=0`` rows are exact argmax (greedy).

Cache backends: the block-pool paged KV cache
(:mod:`repro_torch.serve.kv_cache`) for the decoder families with a KV
cache (dense, moe, vlm), and the seed's dense per-slot cache for the
recurrent families (ssm, hybrid) and the encoder-decoder, whose prefills
run at the prompt's exact length (an encdec engine asked for pages falls
back to dense slots, as the reference's does).  ``extra_inputs`` are the
family's side inputs (:func:`repro_torch.serve.router.default_extra_inputs`):
every prefill gets the vlm family's ``patches`` or the encdec family's
encoder frames ``enc``, and ``enc_len`` sizes the dense slots'
cross-attention cache.
``ServeConfig(paged=False, pipeline_admission=False)`` reproduces the seed
engine (dense cache, prefill inline in the decode loop) for A/B runs.

Engine work runs on scheduler threads, and autograd's grad mode is
thread-local, so each prefill task and each decode step enters
``torch.inference_mode()`` itself.

PyTorch runs eagerly and compiles nothing, so the counterpart of the
reference's decode compile count is :meth:`Engine.decode_compile_count`:
the distinct (shape, dtype) signatures the decode step has been called
with — what a jit would have compiled once each, and what a CUDA graph of
the step would capture once each.

Live migration (the paged backend only, as in the reference): ``pause``
quiesces at a step boundary, ``take_requests`` drains every request into a
picklable snapshot (active slots with their live KV pages, queued ones as
prompts), and ``restore_requests`` rebuilds them slot for slot in another
engine, which continues mid-generation (:mod:`repro_torch.fleet.migrate`).

Performance counters: ``/serve{<name>}/requests/{submitted,completed}``,
``/serve{<name>}/tokens/generated``, ``/serve{<name>}/step/duration``,
``/serve{<name>}/request/{latency,first_token}``,
``/serve{<name>}/requests/migrated_{in,out}``, plus the page-pool gauges
from :mod:`repro_torch.serve.kv_cache`.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import counters as _counters
from repro_torch.core import executor as _executor
from repro_torch.core.future import Channel, Future, Promise
from repro_torch.core.scheduler import PRIORITY_HIGH, current_runtime
from repro_torch.models.model import Model
from repro_torch.obs import trace as _trace
from repro_torch.serve.kv_cache import PagedKVCache

_NEG = -1e30


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls. ``temperature=0`` → greedy (exact
    argmax, independent of top_k/top_p)."""
    temperature: float = 0.0
    top_k: int = 0      # 0 = disabled
    top_p: float = 1.0  # 1.0 = disabled


GREEDY = SamplingParams()


@dataclass
class ServeConfig:
    max_batch: int = 4
    cache_len: int = 256
    max_new_tokens: int = 32
    eos_id: int = -1  # -1: never stops early
    # paged cache layer
    paged: bool = True       # block-pool cache (KV families); else dense slots
    page_size: int = 16
    num_pages: int = 0       # 0 → auto: every slot can reach cache_len
    # engine pipeline
    pipeline_admission: bool = True  # False → seed-style inline prefill barrier
    prefill_oversub: int = 2  # prefills in flight beyond free slots
    idle_timeout: float = 0.05  # blocking queue wait when drained (no hot-spin)
    # the decode continuation chain runs on ``decode_pool``; prefill tasks
    # go to a PriorityExecutor over ``prefill_pool`` (auto-partitioned with
    # ``prefill_workers`` workers, else the decode pool at PRIORITY_HIGH)
    decode_pool: str = "default"
    prefill_pool: str = "prefill"
    prefill_workers: int = 2
    # Counters are get-or-create by name: same-named engines share them.
    # Replicas behind a Router use distinct names (Router.replicate does).
    name: str = "engine#0"
    seed: int = 0


@dataclass
class _Request:
    rid: int
    prompt: List[int]
    max_new: int
    promise: Promise
    sampling: SamplingParams
    stream: Optional[Channel]
    generated: List[int] = field(default_factory=list)
    submit_t: float = 0.0
    first_token_t: float = 0.0
    meta: Optional[Dict[str, Any]] = None
    # request tag stamped into every span (router tag or a local one)
    tag: str = ""


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temp: torch.Tensor, topk: torch.Tensor,
                  topp: torch.Tensor) -> torch.Tensor:
    """Batched sampling with per-row controls.

    logits: (B, V) fp32; temp/topp: (B,) fp32; topk: (B,) int (0 = off),
    on any device.  Rows with temp <= 0 return exact argmax (first maximal
    index, as ``jnp.argmax``).  top-k/top-p masks are derived in sorted
    space; the sampled rows add Gumbel noise drawn from ``generator``."""
    B, V = logits.shape
    greedy = torch.argmax(logits, dim=-1)
    if not bool((temp > 0).any()):  # all-greedy batches skip the sort
        return greedy
    dev = logits.device
    temp, topk, topp = temp.to(dev), topk.to(dev), topp.to(dev)
    t = torch.where(temp > 0, temp, torch.ones_like(temp)).float()
    lg = logits.float() / t[:, None]
    srt = torch.sort(lg, dim=-1, descending=True).values
    k_eff = torch.where(topk > 0, topk, torch.full_like(topk, V)).long()
    kth = torch.gather(srt, 1, (k_eff[:, None] - 1).clamp(0, V - 1))
    lg = torch.where(lg < kth, torch.full_like(lg, _NEG), lg)
    # nucleus: smallest sorted prefix with mass ≥ top_p (in the top-k set)
    ar = torch.arange(V, device=dev)[None, :]
    srt_k = torch.where(ar < k_eff[:, None], srt, torch.full_like(srt, _NEG))
    p_srt = torch.softmax(srt_k, dim=-1)
    excl = torch.cumsum(p_srt, dim=-1) - p_srt
    ncut = (excl < topp[:, None]).sum(dim=-1).clamp_min(1)
    cutoff = torch.gather(srt_k, 1, (ncut - 1)[:, None])
    lg = torch.where(lg < cutoff, torch.full_like(lg, _NEG), lg)
    # Gumbel(0, 1) = -log(E), E ~ Exp(1); E is kept off 0 so the noise stays
    # finite and a −1e30-masked token can never win
    e = torch.empty_like(lg).exponential_(generator=generator)
    g = -e.clamp_min_(torch.finfo(torch.float32).tiny).log()
    samp = torch.argmax(lg + g, dim=-1)
    return torch.where(temp <= 0, greedy, samp)


def _sample_host(logits: np.ndarray, sp: SamplingParams,
                 rng: np.random.Generator) -> int:
    """Host-side mirror of :func:`sample_logits` for the B=1 prefill token."""
    if sp.temperature <= 0:
        return int(np.argmax(logits))
    lg = logits.astype(np.float64) / sp.temperature
    srt = np.sort(lg)[::-1]
    if sp.top_k > 0:
        lg = np.where(lg < srt[min(sp.top_k, lg.size) - 1], _NEG, lg)
        srt = np.where(np.arange(srt.size) < sp.top_k, srt, _NEG)
    p = np.exp(srt - srt.max())
    p /= p.sum()
    excl = np.cumsum(p) - p
    ncut = max(int((excl < sp.top_p).sum()), 1)
    lg = np.where(lg < srt[ncut - 1], _NEG, lg)
    return int(np.argmax(lg + rng.gumbel(size=lg.shape)))


# --------------------------------------------------------------- backends
def _cache_batch_axis(name: str) -> int:
    return 0 if name == "pos" else 1


class _DenseSlots:
    """The seed's dense per-slot cache: the family's own cache at
    ``max_batch`` rows (dense: (L, max_batch, cache_len, KV, Dh) K/V; ssm:
    conv and SSD states; hybrid: rec states and the window ring; encdec:
    self K/V and the cross K/V of ``enc_len`` frames).  The decode step
    updates it in place."""

    def __init__(self, model: Model, scfg: ServeConfig, extra: Dict[str, Any]):
        self.cache = model.init_cache(scfg.max_batch, scfg.cache_len,
                                      enc_len=extra.get("enc_len"))

    def admit(self, slot: int, prefill_cache: Dict[str, torch.Tensor],
              length: int) -> bool:
        """Copy the one-row prefill cache into row ``slot``."""
        for k, v in self.cache.items():
            if _cache_batch_axis(k) == 1:
                v[:, slot] = prefill_cache[k][:, 0].to(v.dtype)
            else:
                v[slot] = prefill_cache[k][0].to(v.dtype)
        return True

    def prepare_step(self, slot: int) -> bool:
        return True

    def release(self, slot: int) -> None:
        pass

    def device_cache(self) -> Dict[str, torch.Tensor]:
        return self.cache

    def commit(self, new_cache: Dict[str, torch.Tensor]) -> None:
        """Copy what the step returned anew (``pos``) into the slot cache's
        own tensors, which thus stay the same objects, made outside
        inference mode, so admission may write them."""
        for k, v in new_cache.items():
            if v is not self.cache[k]:
                self.cache[k].copy_(v)

    def step_bookkeeping(self, active: List[int]) -> None:
        pass  # the step advanced every row's pos on the device

    def snapshot_slot(self, slot: int) -> Dict[str, Any]:
        raise NotImplementedError(
            "dense cache backend does not support live migration — "
            "use the paged backend (ServeConfig.paged=True)")

    def restore_slot(self, slot: int, snap: Dict[str, Any]) -> bool:
        raise NotImplementedError(
            "dense cache backend does not support live migration — "
            "use the paged backend (ServeConfig.paged=True)")


class _PagedSlots:
    """Block-pool paged cache backend (see :mod:`repro_torch.serve.kv_cache`)."""

    def __init__(self, model: Model, scfg: ServeConfig):
        page = scfg.page_size
        if scfg.cache_len % page:
            raise ValueError(f"cache_len {scfg.cache_len} is not a multiple "
                             f"of page_size {page}")
        maxp = scfg.cache_len // page
        self.kv = PagedKVCache(model, num_pages=scfg.num_pages or (scfg.max_batch * maxp + 1),
                               page_size=page, max_batch=scfg.max_batch,
                               max_pages_per_req=maxp, name=scfg.name)

    def admit(self, slot, prefill_cache, length) -> bool:
        return self.kv.admit(slot, prefill_cache, length)

    def prepare_step(self, slot: int) -> bool:
        return self.kv.ensure_next_token(slot)

    def release(self, slot: int) -> None:
        self.kv.release(slot)

    def device_cache(self) -> Dict[str, torch.Tensor]:
        return self.kv.device_cache()

    def commit(self, new_cache: Dict[str, torch.Tensor]) -> None:
        pass  # the step wrote the new tokens' K/V into the pools in place

    def step_bookkeeping(self, active: List[int]) -> None:
        self.kv.pos[active] += 1

    def snapshot_slot(self, slot: int) -> Dict[str, Any]:
        return self.kv.snapshot_slot(slot)

    def restore_slot(self, slot: int, snap: Dict[str, Any]) -> bool:
        return self.kv.restore_slot(slot, snap)


# ----------------------------------------------------------------- engine
class Engine:
    def __init__(self, model: Model, params: Dict[str, torch.Tensor],
                 scfg: ServeConfig, extra_inputs: Optional[Dict[str, Any]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine asked "
                             f"for {self.device}")
        self.model = model
        # the compute-dtype copy, made once (a no-op when the caller already
        # passes one, e.g. Router.replicate): bit-identical to the
        # reference's cast at every use, since the weights are frozen
        self.params = model.compute_params(params)
        self.scfg = scfg
        self.extra = extra_inputs or {}
        # what each prefill gets besides the tokens
        self.prefill_inputs = {k: v for k, v in self.extra.items() if k != "enc_len"}
        B = scfg.max_batch
        self.paged = scfg.paged and model.supports_paged
        self.backend = (_PagedSlots(model, scfg) if self.paged
                        else _DenseSlots(model, scfg, self.extra))
        # bucketed (right-padded) prefill needs valid_len (the KV families)
        # and belongs to the pipelined stack; the seed-parity baseline and
        # the recurrent families prefill at the prompt's exact length
        self._bucketed = model.supports_paged and scfg.pipeline_admission
        self.slots: List[Optional[_Request]] = [None] * B
        self._tokens = np.zeros((B, 1), np.int64)
        self._temp = np.zeros((B,), np.float32)
        self._topk = np.zeros((B,), np.int64)
        self._topp = np.ones((B,), np.float32)
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._ready: List[Tuple[_Request, Dict[str, torch.Tensor], int, int]] = []
        self._inflight_prefills = 0
        self._work_event = threading.Event()  # prefill completion wakeup
        self._lock = threading.Lock()
        self._running = False
        self._paused = False
        self._migrate_key: Optional[Tuple[int, int]] = None
        self._rid = 0
        self.step_count = 0
        self.prefill_count = 0
        self._decode_signatures: set = set()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(scfg.seed)

        # Execution resources (HPX resource partitioner): executors are the
        # only path to scheduler pools; names resolve at submission.
        rt = current_runtime()
        if rt is not None and scfg.pipeline_admission:
            rt.add_pool(scfg.prefill_pool, scfg.prefill_workers)
        self._loop_exec = _executor.get_executor(
            scfg.decode_pool, fallback=scfg.decode_pool)  # → runtime default
        self._prefill_exec = _executor.get_executor(
            scfg.prefill_pool, priority=PRIORITY_HIGH, fallback=scfg.decode_pool)

        reg = _counters.default()
        n = scfg.name
        self.c_sub = reg.counter(f"/serve{{{n}}}/requests/submitted")
        self.c_done = reg.counter(f"/serve{{{n}}}/requests/completed")
        self.c_tok = reg.counter(f"/serve{{{n}}}/tokens/generated")
        self.t_step = reg.timer(f"/serve{{{n}}}/step/duration", percentiles=True)
        self.t_latency = reg.timer(f"/serve{{{n}}}/request/latency",
                                   percentiles=True)
        self.t_first = reg.timer(f"/serve{{{n}}}/request/first_token",
                                 percentiles=True)
        # live-migration accounting: migrated-out counts toward completed so
        # load() stays "requests this engine still has to do"
        self.c_mig_out = reg.counter(f"/serve{{{n}}}/requests/migrated_out")
        self.c_mig_in = reg.counter(f"/serve{{{n}}}/requests/migrated_in")
        # live tail-latency gauges: what the flight-recorder trigger polls
        # through the sampler (seconds, from the timer histograms).  They
        # hold the timers, not the engine, so the registry never keeps an
        # engine's cache alive
        t_latency, t_first = self.t_latency, self.t_first
        reg.register_callable(f"/serve{{{n}}}/request/latency/p99",
                              lambda: t_latency.quantile(0.99))
        reg.register_callable(f"/serve{{{n}}}/request/first_token/p99",
                              lambda: t_first.quantile(0.99))

    @property
    def kv(self) -> PagedKVCache:
        """The paged backend's block pool (no dense backend has one)."""
        return self.backend.kv

    def close(self) -> None:
        """Drop the engine's AGAS record (the paged backend's pools), so
        that its cache is freed with the engine; call once it has stopped
        serving."""
        if self.paged:
            self.kv.close()

    # --------------------------------------------------------------- decode
    def _decode(self, cache: Dict[str, torch.Tensor], token: torch.Tensor):
        self._decode_signatures.add(tuple(
            (k, tuple(v.shape), v.dtype) for k, v in sorted({**cache, "token": token}.items())))
        if self.paged:
            return self.model.decode_paged(self.params, cache, token)
        return self.model.decode(self.params, cache, token)

    def decode_compile_count(self) -> int:
        """Distinct (shape, dtype) signatures of the decode step's inputs
        (cache and tokens): stays 1 after warm-up, since admission churn
        never changes the step's shapes."""
        return len(self._decode_signatures)

    # ------------------------------------------------------------------ api
    def submit(self, prompt: List[int], max_new: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               stream: Optional[Channel] = None,
               meta: Optional[Dict[str, Any]] = None) -> Future:
        """One-sided request → Future[List[int]] of generated ids.

        ``stream``: optional Channel — every generated token is ``set()``
        the step it is sampled and the channel closes when the request
        finishes.  ``meta``: picklable routing info carried through live
        migration (the fleet relay's client locality and stream id)."""
        if self._migrate_key is not None:
            # engine migrated away: answer with the stale-resolution signal
            # so the caller's apply_remote retry re-resolves to the new home
            from repro_torch.net.locality import UnknownGid
            from repro_torch.net.locality import current as _net_current

            net = _net_current()
            raise UnknownGid(self._migrate_key,
                             net.locality if net is not None else -1)
        # the KV families' caches hold cache_len positions; the recurrent
        # families' states do not grow with the prompt
        if not prompt or (self.model.supports_paged and len(prompt) > self.scfg.cache_len):
            raise ValueError(f"prompt length {len(prompt)} outside "
                             f"1..{self.scfg.cache_len}")
        with self._lock:
            self._rid += 1
            rid = self._rid
        tag = (meta or {}).get("req") or f"{self.scfg.name}/{rid}"
        req = _Request(rid, list(prompt),
                       self.scfg.max_new_tokens if max_new is None else max_new,
                       Promise(), sampling or GREEDY, stream,
                       submit_t=time.perf_counter(), meta=meta, tag=tag)
        self._queue.put(req)
        self.c_sub.increment()
        if _trace._enabled:  # request lifetime as one async span
            _trace.async_begin("request", rid, "serve",
                               prompt_len=len(req.prompt), req=tag,
                               slo=(meta or {}).get("slo"))
        self._ensure_running()
        return req.promise.future()

    def submit_stream(self, prompt: List[int], max_new: Optional[int] = None,
                      sampling: Optional[SamplingParams] = None
                      ) -> Tuple[Channel, Future]:
        ch: Channel = Channel()
        return ch, self.submit(prompt, max_new, sampling, stream=ch)

    def load(self) -> float:
        """In-flight requests (queued + prefilling + decoding) — the
        router's least-loaded dispatch metric."""
        return self.c_sub.get_value() - self.c_done.get_value()

    def occupancy(self) -> float:
        """Fraction of KV capacity in use (paged: block-pool pages; dense:
        occupied slots) — the admission-control signal."""
        if self.paged:
            kv = self.backend.kv
            return kv.pages_in_use() / max(kv.num_pages - 1, 1)
        return sum(s is not None for s in self.slots) / self.scfg.max_batch

    def _ensure_running(self) -> None:
        with self._lock:
            if not self._running and not self._paused:
                self._running = True
                self._loop_exec.post(self._step)

    # ---------------------------------------------------------- migration
    def pause(self, timeout: float = 30.0) -> None:
        """Quiesce at a step boundary: stop the decode continuation chain
        and wait for in-flight prefills to land.  Queued / ready / active
        requests stay put; ``resume`` restarts the chain.  Once this
        returns, the last step's tokens are in the host mirrors."""
        self._paused = True
        deadline = time.perf_counter() + timeout
        while True:
            with self._lock:
                if not self._running and self._inflight_prefills == 0:
                    return
            if time.perf_counter() > deadline:
                raise TimeoutError(f"engine {self.scfg.name}: pause timed out")
            time.sleep(0.002)

    def resume(self) -> None:
        self._paused = False
        self._ensure_running()

    def close_for_migration(self, key: Tuple[int, int]) -> None:
        """Point of no return for live migration: every subsequent
        ``submit`` raises ``UnknownGid`` for ``key`` (this engine's GID),
        so remote callers' retry loop re-resolves through the AGAS root —
        which, once the destination adopts, names the new home."""
        self._migrate_key = tuple(key)

    def take_requests(self) -> Dict[str, Any]:
        """Drain every in-flight request into a picklable snapshot (the
        ship half of live migration; the engine must be paused).

        Active slots travel with their paged KV (``snapshot_slot``) and the
        host mirrors of their last token and sampling controls, and resume
        mid-generation at the destination; queued / prefill-ready requests
        travel as prompts (their prefill work is discarded — nothing was
        emitted for them yet, the destination prefills again).  Requests
        must carry relay ``meta``: promises and channels are
        process-local, so only fleet-submitted traffic (whose relay
        re-attaches from meta) can be re-homed — anything else fails
        loudly rather than hang."""
        if not self._paused or self._running:
            raise RuntimeError("take_requests requires a paused engine")

        def _entry(req: _Request, kv=None, last_tok=None) -> Dict[str, Any]:
            # "client" marks relay meta specifically: router-tagged local
            # submits carry meta={"req","slo"} but no re-homeable sink
            if not req.meta or "client" not in req.meta:
                raise RuntimeError(
                    f"request {req.rid} has no relay meta; only "
                    f"fleet-submitted requests survive migration")
            e: Dict[str, Any] = {
                "prompt": req.prompt, "generated": req.generated,
                "max_new": req.max_new,
                "sampling": (req.sampling.temperature, req.sampling.top_k,
                             req.sampling.top_p),
                "meta": req.meta,
            }
            if kv is not None:
                e["kv"] = kv
                e["last_tok"] = last_tok
            return e

        snap: Dict[str, Any] = {"active": [], "queued": []}
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            snap["active"].append(_entry(req, self.backend.snapshot_slot(i),
                                         int(self._tokens[i, 0])))
            self.slots[i] = None
            self.backend.release(i)
            self._temp[i], self._topk[i], self._topp[i] = 0.0, 0, 1.0
            self.c_done.increment()
            self.c_mig_out.increment()
        with self._lock:
            ready, self._ready = self._ready, []
        queued = [r for r, _c, _l, _t in ready]
        while True:
            try:
                queued.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for req in queued:
            snap["queued"].append(_entry(req))
            self.c_done.increment()
            self.c_mig_out.increment()
        return snap

    def _restored_request(self, e: Dict[str, Any]) -> _Request:
        with self._lock:
            self._rid += 1
            rid = self._rid
        t, k, p = e["sampling"]
        meta = dict(e["meta"])
        req = _Request(rid, list(e["prompt"]), int(e["max_new"]), Promise(),
                       SamplingParams(t, k, p), None,
                       generated=list(e["generated"]),
                       submit_t=time.perf_counter(), meta=meta,
                       tag=meta.get("req") or f"{self.scfg.name}/{rid}")
        if req.generated:  # first token happened at the source
            req.first_token_t = req.submit_t
        return req

    def restore_requests(self, snap: Dict[str, Any],
                         reattach: Optional[Any] = None) -> int:
        """Install a :meth:`take_requests` snapshot into this (paused)
        engine.  ``reattach(req)`` runs for every rebuilt request so the
        caller can wire a stream / completion hook from ``req.meta``
        before any token flows.  A sampled request continues on this
        engine's generator.  Returns the number of requests adopted."""
        if not self._paused or self._running:
            raise RuntimeError("restore_requests requires a paused engine")
        n = 0
        for e in snap["active"]:
            free = next((i for i, s in enumerate(self.slots) if s is None),
                        None)
            if free is None:
                raise RuntimeError("destination engine has no free slot for "
                                   "a migrated request")
            if not self.backend.restore_slot(free, e["kv"]):
                raise RuntimeError("destination page pool cannot hold a "
                                   "migrated request's KV")
            req = self._restored_request(e)
            if reattach is not None:
                reattach(req)
            self.slots[free] = req
            self._tokens[free, 0] = int(e["last_tok"])
            self._temp[free] = req.sampling.temperature
            self._topk[free] = req.sampling.top_k
            self._topp[free] = req.sampling.top_p
            self.c_sub.increment()
            self.c_mig_in.increment()
            n += 1
        for e in snap["queued"]:
            req = self._restored_request(e)
            if reattach is not None:
                reattach(req)
            self._queue.put(req)
            self.c_sub.increment()
            self.c_mig_in.increment()
            n += 1
        return n

    # ------------------------------------------------------------ admission
    def _bucket_for(self, n: int) -> int:
        """Smallest power-of-two bucket (≥ page_size) covering n, clamped to
        cache_len — a few prefill shapes, reused across requests."""
        b = max(self.scfg.page_size, 8)
        while b < n:
            b *= 2
        return min(b, self.scfg.cache_len)

    def _run_prefill(self, req: _Request):
        """Compute the request's KV cache + first token (any thread)."""
        if _trace._enabled:
            with _trace.span("prefill", "serve", rid=req.rid, req=req.tag,
                             prompt_len=len(req.prompt)):
                return self._run_prefill_body(req)
        return self._run_prefill_body(req)

    def _run_prefill_body(self, req: _Request):
        prompt = req.prompt
        cfg = self.model.cfg
        if cfg.family == "vlm" and len(prompt) < cfg.n_patches:
            # the patches take the first n_patches positions; a shorter
            # prompt would read its logits inside the patch region
            raise ValueError(f"vlm prompt needs ≥ {cfg.n_patches} tokens, "
                             f"got {len(prompt)}")
        with torch.inference_mode():
            if self._bucketed:
                bucket = self._bucket_for(len(prompt))
                toks = np.zeros((1, bucket), np.int64)
                toks[0, : len(prompt)] = prompt
                logits, cache1 = self.model.prefill(
                    self.params,
                    {"tokens": torch.from_numpy(toks).to(self.device), **self.prefill_inputs},
                    cache_len=bucket if self.paged else self.scfg.cache_len,
                    valid_len=torch.tensor([len(prompt)], dtype=torch.int32,
                                           device=self.device))
            else:
                toks = torch.tensor([prompt], dtype=torch.int64, device=self.device)
                logits, cache1 = self.model.prefill(
                    self.params, {"tokens": toks, **self.prefill_inputs},
                    cache_len=self.scfg.cache_len)
            host_logits = logits[0].float().cpu().numpy()
        with self._lock:
            self.prefill_count += 1
        rng = np.random.default_rng((self.scfg.seed << 20) ^ req.rid)
        tok0 = _sample_host(host_logits, req.sampling, rng)
        return req, cache1, len(prompt), tok0

    def _prefill_task(self, req: _Request) -> None:
        try:
            payload = self._run_prefill(req)
        except BaseException as e:  # noqa: BLE001 — fail the one request
            with self._lock:
                self._inflight_prefills -= 1
            self._fail(req, e)
            self._work_event.set()
            return
        with self._lock:
            self._ready.append(payload)
            self._inflight_prefills -= 1
        self._work_event.set()
        self._ensure_running()

    def _pump_prefills(self) -> None:
        """Launch PRIORITY_HIGH prefill tasks for queued requests, keeping a
        bounded oversubscription so integration always has work ready."""
        while True:
            with self._lock:
                active = sum(s is not None for s in self.slots)
                budget = (self.scfg.max_batch - active
                          + self.scfg.prefill_oversub
                          - self._inflight_prefills - len(self._ready))
            if budget <= 0:
                return
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            self._launch_prefill(req)

    def _launch_prefill(self, req: _Request) -> None:
        with self._lock:
            self._inflight_prefills += 1
        self._prefill_exec.post(lambda: self._prefill_task(req))

    # ---------------------------------------------------------- integration
    def _emit(self, req: _Request, tok: int) -> None:
        req.generated.append(tok)
        self.c_tok.increment()
        if _trace._enabled:  # inter-token latency = gaps between these
            _trace.async_instant("token", req.rid, "serve",
                                 n=len(req.generated))
        if not req.first_token_t:
            req.first_token_t = time.perf_counter()
            self.t_first.add(req.first_token_t - req.submit_t)
        if req.stream is not None:
            req.stream.set(tok)

    def _fail(self, req: _Request, exc: BaseException) -> None:
        if req.stream is not None:
            req.stream.close()
        self.c_done.increment()  # terminated: keep load() = in-flight
        if _trace._enabled:
            _trace.async_end("request", req.rid, "serve", failed=True,
                             req=req.tag)
        req.promise.set_exception(exc)

    def _finish(self, i: int) -> None:
        req = self.slots[i]
        self.slots[i] = None
        self.backend.release(i)
        self._temp[i], self._topk[i], self._topp[i] = 0.0, 0, 1.0
        self.c_done.increment()
        self.t_latency.add(time.perf_counter() - req.submit_t)
        if _trace._enabled:
            _trace.async_end("request", req.rid, "serve",
                             tokens=len(req.generated), req=req.tag)
        if req.stream is not None:
            req.stream.close()
        req.promise.set_value(req.generated)

    def _done_after(self, req: _Request, tok: int) -> bool:
        return (len(req.generated) >= req.max_new + 1
                or tok == self.scfg.eos_id)

    def _bind_slot(self, i: int, req: _Request, tok0: int) -> None:
        """Occupy slot ``i`` with an admitted request and emit its prefill
        token."""
        self.slots[i] = req
        self._tokens[i, 0] = tok0
        self._temp[i] = req.sampling.temperature
        self._topk[i] = req.sampling.top_k
        self._topp[i] = req.sampling.top_p
        self._emit(req, tok0)
        if self._done_after(req, tok0):
            self._finish(i)

    def _integrate_ready(self) -> None:
        while True:
            free = next((i for i, s in enumerate(self.slots) if s is None), None)
            if free is None:
                return
            with self._lock:
                if not self._ready:
                    return
                payload = self._ready.pop(0)
            req, cache1, length, tok0 = payload
            if not self.backend.admit(free, cache1, length):
                if not any(s is not None for s in self.slots):
                    # nothing active will ever free pages → fail the request
                    # instead of wedging the head of the ready queue
                    self._fail(req, RuntimeError(
                        f"request {req.rid}: {length} prompt tokens exceed "
                        f"page-pool capacity"))
                    continue
                if _trace._enabled:
                    _trace.instant("admit_stall", "serve", req=req.tag,
                                   rid=req.rid)
                with self._lock:  # pool exhausted — retry after completions
                    self._ready.insert(0, payload)
                return
            self._bind_slot(free, req, tok0)

    def _admit_inline(self) -> None:
        """Seed-style admission: prefill runs inside the decode loop (the
        barrier).  Kept as the A/B baseline (pipeline_admission=False)."""
        self._integrate_ready()  # admit-failure retries parked in _ready
        for i, slot in enumerate(self.slots):
            if slot is not None:
                continue
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            try:
                req2, cache1, length, tok0 = self._run_prefill(req)
            except BaseException as e:  # noqa: BLE001 — fail the one request
                self._fail(req, e)
                continue
            if not self.backend.admit(i, cache1, length):
                with self._lock:
                    self._ready.insert(0, (req2, cache1, length, tok0))
                return
            self._bind_slot(i, req2, tok0)

    # ----------------------------------------------------------------- loop
    def _idle_or_stop(self) -> bool:
        """No active slots: block briefly on the queue (no hot-spin burning a
        worker) and decide whether the continuation chain ends."""
        with self._lock:
            waiting_on_prefill = bool(self._ready) or self._inflight_prefills > 0
        if waiting_on_prefill:  # integration work is coming — nap, don't spin
            self._work_event.wait(0.005)
            self._work_event.clear()
            return False
        try:
            req = self._queue.get(timeout=self.scfg.idle_timeout)
        except queue.Empty:
            with self._lock:
                if (self._queue.empty() and not self._ready
                        and self._inflight_prefills == 0):
                    self._running = False  # chain ends; submit() restarts it
                    return True
            return False
        if self.scfg.pipeline_admission:
            self._launch_prefill(req)
        else:
            self._queue.put(req)  # inline admission pops it next iteration
        return False

    def _step(self) -> None:
        """One link of the decode continuation chain.  A failing step fails
        every request it holds and ends the chain, instead of leaving their
        futures to time out.  A paused engine ends the chain at this step
        boundary; ``resume`` restarts it."""
        if self._paused:
            with self._lock:
                self._running = False
            return
        try:
            self._step_body()
        except BaseException as e:  # noqa: BLE001 — fail the batch, loudly
            for i, req in enumerate(self.slots):
                if req is not None:
                    self.slots[i] = None
                    self.backend.release(i)
                    self._fail(req, e)
            with self._lock:
                self._running = False
            raise

    def _step_body(self) -> None:
        if self.scfg.pipeline_admission:
            self._pump_prefills()
            self._integrate_ready()
        else:
            self._admit_inline()

        active = [i for i, s in enumerate(self.slots) if s is not None]
        for i in list(active):
            if not self.backend.prepare_step(i):  # can't grow: page capacity
                self._finish(i)
                active.remove(i)

        if not active:
            if self._idle_or_stop():
                return
            self._loop_exec.post(self._step)
            return

        step_args: Dict[str, Any] = {"batch": len(active)}
        if _trace._enabled:
            step_args["reqs"] = [self.slots[i].tag for i in active]
        with _trace.span("decode_step", "serve", **step_args), \
                self.t_step.time(), torch.inference_mode():
            # the step writes the new tokens' K/V and states into the
            # backend's cache in place
            logits, new_cache = self._decode(
                self.backend.device_cache(), torch.from_numpy(self._tokens).to(self.device))
            self.backend.commit(new_cache)
            nxt = sample_logits(logits, self._gen, torch.from_numpy(self._temp),
                                torch.from_numpy(self._topk),
                                torch.from_numpy(self._topp))
            toks = nxt.cpu().numpy()
        self.step_count += 1
        self.backend.step_bookkeeping(active)
        self._tokens[:, 0] = toks
        for i in active:
            req = self.slots[i]
            tok = int(toks[i])
            self._emit(req, tok)
            if self._done_after(req, tok):
                self._finish(i)
        self._loop_exec.post(self._step)  # continuation chain
