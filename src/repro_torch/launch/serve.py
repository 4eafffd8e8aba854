"""Serving launcher: batched requests through the continuous-batching
serving stack (engine replicas behind the least-loaded router), in one
process or over ``--localities N`` OS processes (one engine each), on the
GPU unless ``--device cpu`` is given.  The dense, moe and
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
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2_3b \\
      --smoke --device cpu --requests 12 --localities 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2_3b \\
      --smoke --device cpu --requests 24 --localities 3 --fleet --slo --stream

The observability flags are the reference's: ``--trace`` writes the
merged Chrome trace (fleet-wide with ``--localities``), ``--slow-report``
prints its per-tier SLOW blame, ``--print-counters`` the end-of-run
counter report, ``--metrics-port`` serves ``/metrics`` while the run
lasts, ``--timeline`` persists a JSONL counter timeline and
``--flight-recorder`` arms the anomaly recorder on the fleet controller.
``--fleet``, ``--slo`` and ``--slo-mix`` run the control plane over the
localities; they need more than one, as in the reference, and are refused
otherwise with its messages.  With ``--localities N`` every locality
builds its engine on its own CUDA context (several may share one card).
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
                    help="engine replicas behind the least-loaded router "
                         "(single-locality mode)")
    ap.add_argument("--localities", type=int, default=1,
                    help="OS-process localities; >1 bootstraps "
                         "repro_torch.net and runs one engine per locality")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--no-paged", action="store_true",
                    help="dense per-slot KV cache (seed baseline) instead of pages")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="inline prefill inside the decode loop (seed baseline)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--stream", action="store_true",
                    help="consume tokens via per-request channels (crosses "
                         "localities through the token relay)")
    # fleet control plane
    ap.add_argument("--fleet", action="store_true",
                    help="run the adaptive control plane on locality 0: "
                         "counter sweeps -> policies -> actuators, plus "
                         "gated-batch release each tick (needs "
                         "--localities > 1)")
    ap.add_argument("--slo", action="store_true",
                    help="SLO tiers: first remote engine pinned interactive,"
                         " the rest batch; batch admission gated on gossiped"
                         " KV-page occupancy (hysteresis 0.85/0.60)")
    ap.add_argument("--slo-mix", type=float, default=0.25, metavar="FRAC",
                    help="fraction of requests submitted interactive when "
                         "--slo is on (default 0.25)")
    ap.add_argument("--flight-recorder", metavar="PREFIX", default=None,
                    help="arm the anomaly flight recorder on the fleet "
                         "controller: always-on rings + dump_trace trigger "
                         "rules, anomaly traces written to "
                         "results/PREFIX-N.json (needs --fleet)")
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
    if (args.fleet or args.slo) and args.localities < 2:
        ap.error("--fleet/--slo need --localities > 1 (the control plane "
                 "manages remote engines)")
    if args.slo:
        args.fleet = True  # the gate needs the controller's release tick
    if args.localities > 1 and args.engines != 1:
        ap.error("--engines is single-locality replication; with "
                 "--localities N the topology is one engine per locality")

    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import SamplingParams, ServeConfig
    from repro_torch.serve.router import Router, default_extra_inputs

    cfg = get_config(args.arch, smoke=args.smoke)
    scfg = ServeConfig(max_batch=args.max_batch, cache_len=args.cache_len,
                       max_new_tokens=args.max_new, page_size=args.page_size,
                       paged=not args.no_paged,
                       pipeline_admission=not args.no_pipeline)
    # Resource partition: decode continuations on "default", prefill on its
    # own pool, host I/O (parcels included) on "io".
    pools = {"default": args.workers, "prefill": 2, "io": 1}
    net = model = None
    if args.localities > 1:
        from repro_torch._device import resolve_device

        resolve_device(args.device)  # raises without CUDA, before any spawn
        core.init(pools=pools)
    else:
        model = build_model(cfg, device=args.device)  # raises without CUDA
        core.init(pools=pools)
    exporter = timeline = tl_sampler = controller = recorder = None
    try:
        if args.localities > 1:
            from repro_torch import net as tnet

            net = tnet.bootstrap(args.localities, pools=pools, worker_pools=pools)
            if args.trace:
                from repro_torch.obs import export as obs_export

                obs_export.enable_fleet(net)
            router = Router.over_localities(net, args.arch, scfg, smoke=args.smoke,
                                            device=args.device)
            device = router.engines[0].device
        else:
            if args.trace:
                from repro_torch.obs import trace as obs_trace

                obs_trace.enable()
            params = model.init_compute(args.seed)
            router = Router.replicate(model, params, scfg, args.engines,
                                      extra_inputs=default_extra_inputs(cfg, model.device),
                                      device=model.device)
            del params  # the engines hold their compute-dtype copy
            device = model.device
        if args.slo:
            from repro_torch.fleet import BATCH, INTERACTIVE, AdmissionController
            from repro_torch.serve.router import RemoteEngine

            # first remote engine serves the latency tier, the rest take
            # batch; batch admission rides the occupancy gossip on
            # completion parcels
            remote = [e for e in router.engines if isinstance(e, RemoteEngine)]
            for i, e in enumerate(remote):
                router.set_tier(e.name, INTERACTIVE if i == 0 else BATCH)
            AdmissionController.for_router(router, high=0.85, low=0.60)
        if args.fleet:
            from repro_torch.fleet import FleetController

            controller = FleetController(net, router, interval=0.25)
            if args.flight_recorder:
                from repro_torch.obs.recorder import FlightRecorder

                recorder = FlightRecorder(net, prefix=args.flight_recorder)
                recorder.start()  # always-on rings, fleet-wide
                recorder.install(controller, p99_high=5.0)
            controller.start()
        if args.metrics_port is not None:
            from repro_torch.obs.metrics import MetricsExporter

            exporter = MetricsExporter(net=net, port=args.metrics_port).start()
            print(f"metrics: {exporter.url}", flush=True)
        if args.timeline:
            from repro_torch.obs.sampler import FleetSampler
            from repro_torch.obs.timeseries import TimelineWriter

            timeline = TimelineWriter(args.timeline, pattern="*", interval=0.25,
                                      meta={"launcher": "serve", "arch": args.arch})
            if controller is not None:
                # ride the control plane's sweep — one sampler, two consumers
                controller.sampler.timeline = timeline
            else:
                tl_sampler = FleetSampler(pattern="*", interval=0.25, net=net,
                                          timeline=timeline)
                tl_sampler.sample_once()  # t=0 baseline record
                tl_sampler.start()
        sampling = SamplingParams(temperature=args.temperature,
                                  top_k=args.top_k, top_p=args.top_p)

        def slo_for(i: int):
            if not args.slo:
                return None
            from repro_torch.fleet import BATCH, INTERACTIVE

            return INTERACTIVE if (i % max(round(1 / max(args.slo_mix, 1e-9)), 1)
                                   == 0) else BATCH

        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, cfg.vocab_size, size=rng.integers(4, 32)).tolist()
                   for _ in range(args.requests)]
        t0 = time.perf_counter()
        if args.stream:
            streams = [router.submit_stream(p, sampling=sampling, slo=slo_for(i))
                       for i, p in enumerate(prompts)]
            outs = []
            for ch, fut in streams:
                toks = list(ch)  # arrives token-by-token as slots advance
                outs.append(fut.get(timeout=600))
                if toks != outs[-1]:
                    raise RuntimeError("streamed tokens differ from the result")
        else:
            futures = [router.submit(p, sampling=sampling, slo=slo_for(i))
                       for i, p in enumerate(prompts)]
            outs = [f.get(timeout=600) for f in futures]
        if controller is not None:
            controller.tick()  # final release sweep before measuring
            controller.stop()
        dt = time.perf_counter() - t0
        total_tokens = sum(len(o) for o in outs)
        local = router.engines[0]
        report = {
            "requests": len(outs),
            "engines": len(router.engines),
            "localities": args.localities,
            "device": str(device),
            "paged": local.paged,
            "pipeline_admission": scfg.pipeline_admission,
            "generated_tokens": total_tokens,
            "wall_s": round(dt, 3),
            "tokens_per_s": round(total_tokens / dt, 2),
            "counters": dict(core.counters.query("/serve*")),
        }
        if net is not None:
            from repro_torch import net as tnet

            # per-locality serving counters, read across the parcelport
            report["per_locality_tokens"] = {
                f"locality#{loc}": dict(tnet.query_counters(
                    loc, "/serve{engine*}/tokens/generated"))
                for loc in range(args.localities)
            }
        if args.trace:
            from repro_torch.obs import export as obs_export

            tr = obs_export.export_chrome_trace(args.trace, net=net)
            report["trace"] = {"path": args.trace,
                               "events": len(tr["traceEvents"])}
            if args.slow_report:
                from repro_torch.obs import attribution as obs_attr

                rep = obs_attr.slow_report(tr)
                print(obs_attr.format_report(rep))
                report["slow_report"] = {"requests": rep["requests"],
                                         "tiers": sorted(rep["tiers"])}
        if recorder is not None:
            report["flight_recorder"] = {
                "dumps": int(recorder.c_dumps.get_value()),
                "last": recorder.last_path,
            }
        if args.print_counters:
            from repro_torch.obs import sampler as obs_sampler

            obs_sampler.print_counter_report(args.print_counters, net=net)
        if timeline is not None:
            if tl_sampler is not None:
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
        if controller is not None:
            controller.stop()
        if recorder is not None:
            recorder.stop()
        if tl_sampler is not None:
            tl_sampler.stop()
        if timeline is not None:
            timeline.close()
        if exporter is not None:
            exporter.close()
        if net is not None:
            net.shutdown()
        core.finalize()


if __name__ == "__main__":
    main()
