"""Serving launcher: batched requests through the continuous-batching
serving stack (engine replicas behind the least-loaded router), in one
process, on the GPU unless ``--device cpu`` is given.  The dense, moe and
vlm families serve from the paged cache; ``--no-paged --no-pipeline`` is
the seed's baseline (dense per-slot cache, inline prefill).  The ssm,
hybrid and encdec families always serve from dense slots.  The vlm and
encdec families get the reference's synthetic side inputs
(``default_extra_inputs``: zero patches, 64 zero encoder frames).  As in
the reference, the prompts are 4–31 tokens, so a vlm request shorter than
its ``n_patches`` image positions fails with ``ValueError``.  The params are made one
tensor at a time in the compute dtype (``Model.init_compute``), so the
fp32 masters of a large model never exist together.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2_3b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_780m \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek_moe_16b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper_small \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2_2b \\
      --smoke --device cpu --requests 6
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2_3b \\
      --smoke --device cpu --no-paged --no-pipeline
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2_3b \\
      --requests 16 --max-new 64 --max-batch 8 --cache-len 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2_3b \\
      --smoke --device cpu --trace /tmp/t.json --slow-report \\
      --metrics-port 0 --timeline /tmp/tl.jsonl

The observability flags are the reference's that work at one locality:
``--trace`` writes the merged Chrome trace, ``--slow-report`` prints its
per-tier SLOW blame, ``--print-counters`` the end-of-run counter report,
``--metrics-port`` serves ``/metrics`` while the run lasts, and
``--timeline`` persists a JSONL counter timeline.  ``--fleet``, ``--slo``
and ``--flight-recorder`` need more than one locality, as in the
reference, and are refused with its messages.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without CUDA, only "
                         "--device cpu runs")
    ap.add_argument("--seed", type=int, default=0, help="param init seed")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--engines", type=int, default=1,
                    help="engine replicas behind the least-loaded router")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--no-paged", action="store_true",
                    help="dense per-slot KV cache (seed baseline) instead of pages")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="inline prefill inside the decode loop (seed baseline)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--stream", action="store_true",
                    help="consume tokens via per-request channels")
    # fleet control plane (needs more than one locality)
    ap.add_argument("--fleet", action="store_true",
                    help="the adaptive control plane (needs --localities > 1)")
    ap.add_argument("--slo", action="store_true",
                    help="SLO tiers with occupancy-gated batch admission "
                         "(needs --localities > 1)")
    ap.add_argument("--flight-recorder", metavar="PREFIX", default=None,
                    help="the anomaly flight recorder (needs --fleet)")
    # observability
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="record a task trace and write one merged Chrome "
                         "trace JSON (Perfetto-loadable)")
    ap.add_argument("--print-counters", metavar="PATTERN", default=None,
                    help="end-of-run counter report (HPX --hpx:print-counter "
                         "parity), e.g. '/serve*'")
    ap.add_argument("--slow-report", action="store_true",
                    help="after --trace export, run the critical-path "
                         "analyzer and print the per-tier SLOW blame report "
                         "(python -m repro_torch.obs.analyze parity)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve an OpenMetrics /metrics endpoint (0 = "
                         "ephemeral port); every scrape reads the counters live")
    ap.add_argument("--timeline", metavar="PATH", default=None,
                    help="persist a JSONL counter timeline (bounded by "
                         "stride-doubling downsample); summarize later with "
                         "python -m repro_torch.obs.analyze --timeline")
    args = ap.parse_args()
    if args.slow_report and not args.trace:
        ap.error("--slow-report needs --trace PATH (it analyzes the "
                 "exported merged trace)")
    if args.flight_recorder and not args.fleet:
        ap.error("--flight-recorder needs --fleet (the controller's tick "
                 "evaluates the trigger rules)")
    if args.fleet or args.slo:
        ap.error("--fleet/--slo need --localities > 1 (the control plane "
                 "manages remote engines)")

    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import SamplingParams, ServeConfig
    from repro_torch.serve.router import Router, default_extra_inputs

    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=args.device)  # raises without CUDA
    # Resource partition: decode continuations on "default", prefill on its
    # own pool, host I/O on "io".
    core.init(pools={"default": args.workers, "prefill": 2, "io": 1})
    exporter = timeline = tl_sampler = None
    try:
        if args.trace:
            from repro_torch.obs import trace as obs_trace

            obs_trace.enable()
        scfg = ServeConfig(max_batch=args.max_batch, cache_len=args.cache_len,
                           max_new_tokens=args.max_new, page_size=args.page_size,
                           paged=not args.no_paged,
                           pipeline_admission=not args.no_pipeline)
        params = model.init_compute(args.seed)
        router = Router.replicate(model, params, scfg, args.engines,
                                  extra_inputs=default_extra_inputs(cfg, model.device),
                                  device=model.device)
        del params  # the engines hold their compute-dtype copy
        if args.metrics_port is not None:
            from repro_torch.obs.metrics import MetricsExporter

            exporter = MetricsExporter(port=args.metrics_port).start()
            print(f"metrics: {exporter.url}", flush=True)
        if args.timeline:
            from repro_torch.obs.sampler import FleetSampler
            from repro_torch.obs.timeseries import TimelineWriter

            timeline = TimelineWriter(args.timeline, pattern="*", interval=0.25,
                                      meta={"launcher": "serve", "arch": args.arch})
            tl_sampler = FleetSampler(pattern="*", interval=0.25, timeline=timeline)
            tl_sampler.sample_once()  # t=0 baseline record
            tl_sampler.start()
        sampling = SamplingParams(temperature=args.temperature,
                                  top_k=args.top_k, top_p=args.top_p)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, cfg.vocab_size, size=rng.integers(4, 32)).tolist()
                   for _ in range(args.requests)]
        t0 = time.perf_counter()
        if args.stream:
            streams = [router.submit_stream(p, sampling=sampling) for p in prompts]
            outs = []
            for ch, fut in streams:
                toks = list(ch)  # arrives token-by-token as slots advance
                outs.append(fut.get(timeout=600))
                if toks != outs[-1]:
                    raise RuntimeError("streamed tokens differ from the result")
        else:
            futures = [router.submit(p, sampling=sampling) for p in prompts]
            outs = [f.get(timeout=600) for f in futures]
        dt = time.perf_counter() - t0
        total_tokens = sum(len(o) for o in outs)
        report = {
            "requests": len(outs),
            "engines": len(router.engines),
            "localities": 1,
            "device": str(model.device),
            "paged": router.engines[0].paged,
            "pipeline_admission": scfg.pipeline_admission,
            "generated_tokens": total_tokens,
            "wall_s": round(dt, 3),
            "tokens_per_s": round(total_tokens / dt, 2),
            "counters": dict(core.counters.query("/serve*")),
        }
        if args.trace:
            from repro_torch.obs import export as obs_export

            tr = obs_export.export_chrome_trace(args.trace)
            report["trace"] = {"path": args.trace,
                               "events": len(tr["traceEvents"])}
            if args.slow_report:
                from repro_torch.obs import attribution as obs_attr

                rep = obs_attr.slow_report(tr)
                print(obs_attr.format_report(rep))
                report["slow_report"] = {"requests": rep["requests"],
                                         "tiers": sorted(rep["tiers"])}
        if args.print_counters:
            from repro_torch.obs import sampler as obs_sampler

            obs_sampler.print_counter_report(args.print_counters)
        if timeline is not None:
            tl_sampler.stop()
            tl_sampler.sample_once()  # end-of-run record (≥2 guaranteed)
            timeline.close()
            report["timeline"] = {"path": args.timeline,
                                  "records": timeline.records_written,
                                  "stride": timeline.stride}
        if exporter is not None:
            report["metrics_url"] = exporter.url
        print(json.dumps(report, indent=1))
    finally:
        if tl_sampler is not None:
            tl_sampler.stop()
        if timeline is not None:
            timeline.close()
        if exporter is not None:
            exporter.close()
        core.finalize()


if __name__ == "__main__":
    main()
