"""Open-loop serving through the port's normal entry,
``Engine.submit_stream``, on the paged cache.

Set-up makes the weights on the device from the seed, builds the engine
and sends prompts over the whole length range (every prefill shape the
window meets; the decode step has one shape).  Then the schedule's
requests are sent at their due times, from a lead-in that fills the
engine to the window's end, whether or not earlier ones have finished;
each token is timestamped where the client receives it (a callback on
the request's channel).  Over the window ``[0, seconds)``:

- ``output_tokens_per_s``: tokens received in the window over its length;
- ``ttft_p50_ms``, ``ttft_p95_ms``: the median and the 95th percentile
  over the requests due in the window of first token − due time; a
  request that never answers counts as late as the wait;
- ``itl_p50_ms``, ``itl_p95_ms``: the median and the 95th percentile
  over the gaps between consecutive tokens of a request, the later token
  received in the window.

The harness reports those the cell lists (PERF.md says why no cell lists
the tails; the traced run reads them as per-layer metrics).

Once the window has closed and every request due has answered (or a
minute has passed), the peak memory is read, the engine is freed, and the
plain reference runs over a sample of the finished requests (drawn from
the seed, the longest included): at each served position, the gap by
which the served token's logit lies below the reference's best.  The
cell's file names which number of those gaps it compares
(``gap_stats``: the widest, the mean, ...) and its limit (``judge``).

The reference keeps every decode assignment of a mixture of experts.
That is the port's capacity rule as long as no live row of a decode step
has ``C`` rows ahead of it (``reference.transformer.decode_capacity``):
the engine puts a request in its lowest free slot, so the rows ahead of
a live one number fewer than the requests in flight, and each run
reports their most (``in_flight_max``) beside ``C``.
"""

from __future__ import annotations

import bisect
import gc
import math
import sys
import threading
import time
from typing import Dict, List, Tuple

import numpy as np

ENV: Dict[str, str] = {}


class _Client:
    """One request as the client sees it: its due and send times, and
    the time each token arrived (a callback on the channel, run where the
    engine hands the token over)."""

    __slots__ = ("due", "sent", "prompt", "out_tokens", "in_window", "ch", "fut", "times")

    def __init__(self, r: Dict, due: float):
        self.due, self.prompt, self.out_tokens = due, r["prompt"], r["out_tokens"]
        self.in_window = r["in_window"]
        self.sent = 0.0
        self.times: List[float] = []

    def attach(self, ch, fut) -> None:
        self.ch, self.fut = ch, fut
        ch.get_future().on_ready(self._token)

    def _token(self, f) -> None:
        t = time.perf_counter()
        if f.has_value():  # else the channel closed: the request is done
            self.times.append(t)
            self.ch.get_future().on_ready(self._token)


def _gauge_sampler(name_in_use: str, name_cap: str, out: Dict, stop: threading.Event):
    from repro_torch.core import counters

    reg = counters.default()
    while not stop.wait(0.005):
        t = time.perf_counter()
        out.setdefault(name_in_use, []).append((t, reg.get_value(name_in_use)))
        out.setdefault(name_cap, []).append((t, reg.get_value(name_cap)))


class Session:
    """The program under test for one seed: its weights (the benchmark's
    inputs, kept for the reference) and the engine built on them."""

    def __init__(self, ctx, seed: int, fault=None):
        import torch

        import repro_torch.core as core
        from repro_torch.models.model import Model
        from repro_torch.serve.engine import GREEDY, Engine, ServeConfig

        from perfbench import harness, weights

        self.ctx, self.seed = ctx, seed
        self.sv, self.shape = ctx.config["serving"], ctx.shape
        cfg = harness.port_config(ctx.config)
        self.on_card = ctx.device == "cuda"
        core.init(pools={"default": 2, "prefill": 2, "io": 1})
        model = Model(cfg, device=ctx.device)
        self.inputs = weights.make(weights.layout_of(model.param_specs()), seed, ctx.device,
                                   getattr(torch, cfg.dtype))
        scfg = ServeConfig(max_batch=self.sv["max_batch"], cache_len=self.sv["cache_len"],
                           page_size=self.sv["page_size"],
                           max_new_tokens=ctx.mix["output_tokens"]["max"], prefill_workers=2,
                           name="engine#0", seed=seed % (2 ** 31))
        self.engine = Engine(model, model.compute_params(self.inputs), scfg, device=ctx.device)
        if fault is not None:
            fault(self.engine)
        warm = [self.engine.submit(p.tolist(), max_new=2, sampling=GREEDY)
                for p in ctx.gen.warmup(ctx.mix, seed, self.shape["vocab_size"])]
        for f in warm:
            f.get(timeout=600)
        if self.on_card:
            torch.cuda.synchronize()

    def schedule(self, rate: float, seconds: float):
        mix, sv = self.ctx.mix, self.sv
        sched = self.ctx.gen.schedule(mix, {**self.ctx.params, "rate_per_s": rate}, self.seed,
                                      seconds, self.shape["vocab_size"])
        longest = max(len(r["prompt"]) + r["out_tokens"] for r in sched)
        if longest > min(sv["cache_len"], self.shape.get("max_position", sv["cache_len"])):
            raise ValueError(f"a request of {longest} positions exceeds the cache or the "
                             f"configuration's positions")
        return sched

    def window(self, sched, seconds: float, profiler=None) -> Dict:
        """Send ``sched`` open-loop; → {clients, results, errors, w0, w1,
        deadline, late}.  ``profiler`` runs over the mix's profiled
        stretch, on a thread of its own."""
        from repro_torch.serve.engine import GREEDY

        mix = self.ctx.mix
        lead = float(mix["lead_s"])
        t_base = time.perf_counter() + 0.01
        w0 = t_base + lead
        w1 = w0 + seconds
        clients = [_Client(r, w0 + r["due"]) for r in sched]
        late: List[float] = []
        prof = None
        at = w1
        if profiler is not None:
            at = w0 + mix["profile"]["at"] * seconds
            prof = threading.Thread(target=profiler.stretch, args=(
                at, at + mix["profile"]["seconds"]), daemon=True)
            prof.start()
        for c in clients:
            time.sleep(max(0.0, c.due - time.perf_counter()))
            c.sent = time.perf_counter()
            late.append(c.sent - c.due)
            ch, fut = self.engine.submit_stream(c.prompt.tolist(), max_new=c.out_tokens - 1,
                                                sampling=GREEDY)
            c.attach(ch, fut)
        time.sleep(max(0.0, w1 - time.perf_counter()))
        if prof is not None:
            prof.join()
        deadline = w1 + float(mix["drain_s"])
        results: Dict[int, List[int]] = {}
        errors = 0
        for i, c in enumerate(clients):
            try:
                results[i] = c.fut.get(timeout=max(0.0, deadline - time.perf_counter()))
            except TimeoutError:
                pass
            except Exception as e:  # noqa: BLE001 — a failed request is counted, not raised
                errors += 1
                print(f"request {i} failed: {e!r}", file=sys.stderr)
        return {"clients": clients, "results": results, "errors": errors, "w0": w0, "w1": w1,
                "deadline": deadline, "late": late, "profiled_from": at}

    def close(self) -> None:
        """Free the program's state (the engine, its cache, its threads);
        the weights stay for the reference."""
        import torch

        import repro_torch.core as core

        self.engine.close()
        self.engine = None
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()
        core.finalize()

    def picks(self, w: Dict) -> List[int]:
        """The requests the check reads: a sample of the finished ones
        drawn from the seed, and the longest."""
        check, results = self.ctx.mix["check"], w["results"]
        done = sorted(results)
        if not done:
            return []
        rng = np.random.default_rng([self.seed, 4])
        pick = set(rng.choice(done, size=min(check["requests"], len(done)),
                              replace=False).tolist())
        if check.get("with_longest"):
            pick.add(max(done, key=lambda i: len(w["clients"][i].prompt) + len(results[i])))
        return sorted(pick)


def window_metrics(w: Dict, seconds: float) -> Tuple[Dict[str, float], Dict]:
    """The end-to-end metrics of a window, and counts for the log."""
    from perfbench import stats

    w0, w1, clients = w["w0"], w["w1"], w["clients"]
    due = [c for c in clients if c.in_window]
    ttft = [(c.times[0] - c.due) * 1e3 if c.times else math.inf for c in due]
    itl, n_tok = [], 0
    for c in clients:
        for a, b in zip(c.times, c.times[1:]):
            if w0 <= b < w1:
                itl.append((b - a) * 1e3)
        n_tok += sum(1 for t in c.times if w0 <= t < w1)
    wait = (w["deadline"] - w0) * 1e3  # unanswered requests count as late as the wait
    p50, p95 = (min(stats.percentile(ttft, q), wait) for q in (50, 95))
    unanswered = sum(1 for i, c in enumerate(clients) if c.in_window and i not in w["results"])
    return ({"ttft_p50_ms": p50, "ttft_p95_ms": p95, "itl_p50_ms": stats.percentile(itl, 50),
             "itl_p95_ms": stats.percentile(itl, 95),
             "output_tokens_per_s": stats.rate(n_tok, seconds)},
            {"due": len(due), "gaps": len(itl), "tokens": n_tok, "unanswered": unanswered,
             "ttft": ttft, "in_flight_max": in_flight_max(clients)})


def in_flight_max(clients) -> int:
    """The most requests sent and not yet answered in full at any one
    time: at least as many as the engine's slots held."""
    edges = sorted([(c.sent, 1) for c in clients if c.times]
                   + [(c.times[-1], -1) for c in clients if c.times])
    most = now = 0
    for _, d in edges:
        now += d
        most = max(most, now)
    return most


def judge(ctx, got: Dict[str, float], w: Dict) -> Tuple[List[Tuple[str, float, float]], bool]:
    """(each compared number with its limit, correct): the numbers of
    ``got`` (``gap_stats``) that the cell's file names, every request
    answered, and each at its length."""
    res, clients = w["results"], w["clients"]
    wrong = sum(1 for i in res if len(res[i]) != clients[i].out_tokens)
    checks = [(k, got[k], lim) for k, lim in ctx.params["limits"].items()]
    checks += [("requests_unanswered", float(len(clients) - len(res)), 0.0),
               ("wrong_length", float(wrong), 0.0)]
    return checks, all(v <= lim for _, v, lim in checks)


def run(ctx):
    import torch

    from repro_torch.obs import trace as ptrace

    from perfbench import harness, stats
    from perfbench import profiling as prof_mod

    ses = Session(ctx, ctx.seed, ctx.fault)
    sched = ses.schedule(float(ctx.params["rate_per_s"]), ctx.seconds)
    gauges: Dict = {}
    stop = threading.Event()
    profiler = None
    if ctx.trace:
        if ses.on_card:
            prof_mod.warm(torch)
            profiler = prof_mod.Profiler(record_shapes=True)
        ptrace.enable(capacity=1 << 18)
        sampler = threading.Thread(target=_gauge_sampler, daemon=True, args=(
            "/serve{engine#0}/pages/in_use", "/serve{engine#0}/pages/capacity", gauges, stop))
        sampler.start()
    t_setup = time.perf_counter()
    w = ses.window(sched, ctx.seconds, profiler)
    setup_s = w["w0"] - ctx.t_process
    if ctx.trace:
        stop.set()
        sampler.join(timeout=5)
        # each event's args name the thread that recorded it
        events = [(*e[:6], {**(e[6] or {}), "thread": b["tid"]})
                  for b in ptrace.export_buffers() for e in b["events"]]
        ptrace.disable()
    metrics, n = window_metrics(w, ctx.seconds)
    metrics["setup_s"] = setup_s
    print(f"generator: {len(w['clients'])} requests sent ({n['due']} due in the window), "
          f"latest {max(w['late']) * 1e3:.3f} ms late, p99 "
          f"{stats.percentile(w['late'], 99) * 1e3:.3f} ms; window {n['gaps']} gaps, "
          f"{n['tokens']} tokens; set-up {t_setup - ctx.t_process:.3f} s before the lead-in; "
          + ", ".join(f"{k} {metrics[k]!r}" for k in ("ttft_p50_ms", "ttft_p95_ms", "itl_p50_ms",
                                                     "itl_p95_ms", "output_tokens_per_s")),
          file=sys.stderr)
    notes = [f"in_flight_max {n['in_flight_max']}"]
    if ses.shape.get("n_experts", 0):
        from perfbench.reference import transformer as ref

        notes.append(f"decode capacity C {ref.decode_capacity(ses.shape, ses.sv['max_batch'])}")
    print("requests: " + "; ".join(notes), file=sys.stderr)
    memory_peak = torch.cuda.max_memory_allocated() if ses.on_card else 0
    record = None
    if ctx.trace:
        record = _record(ctx, ses.shape, ses.sv, events, gauges, (w["w0"], w["w1"]),
                         w["clients"], profiler.result if profiler is not None else None)
        record.quiet = (w["w0"], w["profiled_from"])
    ses.close()

    t_ref = time.perf_counter()
    picks = ses.picks(w)
    got = gap_stats(position_gaps(ses, w, picks, fp8=False) if picks else [])
    print(f"reference: {len(picks)} requests, {time.perf_counter() - t_ref:.3f} s; "
          + ", ".join(f"{k} {v!r}" for k, v in got.items()), file=sys.stderr)
    checks, correct = judge(ctx, got, w)
    return harness.Outcome(metrics=metrics, attempted=n["due"], failed=n["unanswered"],
                           correct=bool(picks) and correct, checks=checks,
                           memory_peak_bytes=memory_peak, record=record, notes=notes)


def served_positions(prompt: np.ndarray, served: List[int]):
    """(the sequence the reference reads: the prompt and every served
    token but the last, the positions whose logits chose each served
    token)."""
    import torch

    seq = np.concatenate([prompt, np.asarray(served[:-1], dtype=np.int64)])
    P = len(prompt)
    return torch.from_numpy(seq), torch.arange(P - 1, P - 1 + len(served))


def bucket_of(n: int, sv: Dict) -> int:
    """The prefill's bucket: the power of two from the page size up that
    covers n, at most the cache (the engine's right-padding)."""
    b = max(sv["page_size"], 8)
    while b < n:
        b *= 2
    return min(b, sv["cache_len"])


def position_gaps(ses: Session, w: Dict, picks: List[int], fp8: bool) -> List:
    """Per picked request, the gap at each served position by which the
    served token's logit lies below the reference's best; with ``fp8``
    the control's: the gap of the token the fp8 reference puts first."""
    import torch

    from perfbench.reference import transformer as ref

    ref.fp32_matmuls()
    dev, shape, sv = ses.ctx.device, ses.shape, ses.sv
    seqs, poss, caps, served = [], [], [], []
    for i in picks:
        prompt, toks = w["clients"][i].prompt, w["results"][i]
        s, p = served_positions(prompt, toks)
        seqs.append(s.to(dev))
        poss.append(p.to(dev))
        caps.append((len(prompt), bucket_of(len(prompt), sv)) if shape.get("n_experts", 0)
                    else None)
        served.append(torch.tensor(toks, device=dev))
    gold = ref.logits_at(shape, shape, ses.inputs, seqs, poss, caps)
    chosen = ([lg.argmax(-1) for lg in ref.logits_at(shape, shape, ses.inputs, seqs, poss,
                                                      caps, fp8=True)]
              if fp8 else served)
    return [(g.max(-1).values - g.gather(1, c[:, None].long())[:, 0]).cpu()
            for g, c in zip(gold, chosen)]


def gap_stats(gaps: List) -> Dict[str, float]:
    """Numbers a serving cell can compare, over every served position of
    the picked requests: the widest gap, the mean gap, the 90th
    percentile, and the share of positions whose token is not the
    reference's first (inf with nothing to read)."""
    import torch

    if not gaps:
        return {k: math.inf for k in ("logit_gap_max", "logit_gap_mean", "logit_gap_p90",
                                      "logit_not_first")}
    g = torch.cat(gaps).double()
    return {"logit_gap_max": float(g.max()), "logit_gap_mean": float(g.mean()),
            "logit_gap_p90": float(torch.quantile(g, 0.9)),
            "logit_not_first": float((g > 0).double().mean())}


def _record(ctx, shape, sv, events, gauges, window, clients, profile):
    from perfbench import harness

    spans = [(e[1], e[3], e[3] + e[4], e[6] or {}) for e in events
             if e[0] == "X" and e[1] in ("prefill", "decode_step")]
    rec = harness.Record(shape=shape, peaks={}, window=window, spans=spans, gauges=gauges,
                         profile=profile, page_size=sv["page_size"], rows=sv["max_batch"])
    steps = sorted((a, b) for n, a, b, _ in spans if n == "decode_step")
    ends = [b for _, b in steps]
    lengths: List[List[int]] = [[] for _ in steps]
    for c in clients:
        P = len(c.prompt)
        for i, t in enumerate(c.times[1:], start=1):
            k = bisect.bisect_right(ends, t) - 1
            if k >= 0:
                lengths[k].append(P + i)
    rec.decode_lengths = [(a, b, ls) for (a, b), ls in zip(steps, lengths)]
    rec.requests = [(c.due, list(c.times)) for c in clients]
    if profile is not None:
        profile.names = [(n, profile.to_ns(a), profile.to_ns(b)) for n, a, b, _ in spans
                         if profile.to_ns(b) >= profile.t0_ns and profile.to_ns(a) <= profile.t1_ns]
    return rec
