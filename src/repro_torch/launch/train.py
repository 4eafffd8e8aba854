"""Training launcher: the futurized trainer on one device, on the GPU
unless ``--device cpu`` is given.  Prints one JSON line per logged step,
then the ``/train*`` counters.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2_3b \\
      --smoke --device cpu --steps 20 --batch 4 --seq 32 --log-every 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2_3b \\
      --smoke --device cpu --steps 8 --ckpt-every 4 --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2_3b \\
      --steps 6 --batch 2 --seq 512 --log-every 1
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_moe_3b_a800m \\
      --smoke --device cpu --steps 6 --batch 2 --seq 32 --log-every 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper_small \\
      --smoke --device cpu --steps 6 --batch 2 --seq 32 --log-every 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2_3b \\
      --smoke --device cpu --steps 4 --batch 2 --seq 16 --log-every 2 \\
      --localities 2 --sharded-rows 64 --trace /tmp/t.json \\
      --print-counters '/train*' --metrics-port 0 --timeline /tmp/tl.jsonl

Every family trains: dense, moe (its router aux loss in the objective),
vlm (no loss on the image positions), ssm and hybrid (their scans
through the trainable ops) and encdec (the encoder over ``enc`` frames,
one per decoder position, as the reference's synthetic batches carry).

The reference's fleet and observability flags: ``--localities N`` brings
up N OS-process localities (``repro_torch.net``); ``--sharded-rows R``
makes a locality-sharded dataset of R token rows, synthesized in place at
each owning locality on the same device kind as the trainer (``--device``),
and the trainer at locality 0 feeds only from its own segments
(``data.LocalShardFeeder``); both refuse ``--scheduler`` other than
``local``, as the reference does.  ``--trace`` writes the merged Chrome
trace of every locality, ``--print-counters`` the end-of-run fleet
counter report, ``--metrics-port`` serves ``/metrics`` while the run
lasts, ``--timeline`` persists a JSONL counter timeline.

``main(argv)`` returns the run's report (the loss history, the sharded
dataset's line and its feeder), so the launcher can be driven in process.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Any, Dict, List, Optional


def _wire_bytes(net) -> float:
    """Bytes every locality has sent over the parcelport so far."""
    from repro_torch import net as tnet

    sweep = tnet.query_counters(None, "/net{*}/bytes/sent")
    return float(sum(v for pairs in sweep.values() for _k, v in pairs))


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--plan", default="futurized")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--scheduler", default="local",
                    choices=("static", "local", "hierarchical"))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without CUDA, only "
                         "--device cpu runs")
    ap.add_argument("--localities", type=int, default=1,
                    help="multi-locality runtime: N OS processes")
    ap.add_argument("--sharded-rows", type=int, default=0,
                    help="locality-sharded dataset of this many token rows "
                         "(synthesized in place at each owning locality); "
                         "the trainer feeds from locality 0's segments")
    # observability
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="record a fleet-wide task/parcel trace and write "
                         "one merged Chrome trace JSON (Perfetto-loadable)")
    ap.add_argument("--print-counters", metavar="PATTERN", default=None,
                    help="end-of-run fleet counter report (HPX "
                         "--hpx:print-counter parity), e.g. '/train*'")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve an OpenMetrics /metrics endpoint from "
                         "locality 0 (0 = ephemeral port)")
    ap.add_argument("--timeline", metavar="PATH", default=None,
                    help="persist a JSONL counter timeline; summarize with "
                         "python -m repro_torch.obs.analyze --timeline")
    args = ap.parse_args(argv)

    # Set before CUDA starts: the caching allocator then grows segments in
    # place instead of keeping freed blocks of fixed-size segments apart.
    # Without it a 16,384-token step of granite_moe_3b_a800m (~69 GiB live
    # at its peak on an 80 GB card) finds its reserved memory split too
    # finely for its 3.75 GiB stacked expert gradients.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

    import repro_torch.core as core
    from repro_torch._device import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, ShardedTokenDataset
    from repro_torch.dist.plan import get_plan
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    device = resolve_device(args.device)  # raises without CUDA, before any spawn
    # Resource partition: compute-plane tasks on "default", prefetch
    # assembly and checkpoint writes on the single-worker "io" pool.  A
    # sharded dataset needs the net runtime even at one locality.
    pools = {"default": args.workers, "io": 1}
    if args.localities > 1 or args.sharded_rows > 0:
        if args.scheduler != "local":
            ap.error("--scheduler is not supported together with "
                     "--localities/--sharded-rows (the multi-locality "
                     "bootstrap brings up the default scheduler)")
        from repro_torch import net as tnet

        ctx = tnet.running(max(args.localities, 1), pools=pools)
    else:
        core.init(policy=args.scheduler, pools=pools)
        ctx = contextlib.nullcontext()
    report: Dict[str, Any] = {}
    exporter = timeline = tl_sampler = trainer = None
    try:
        with ctx as net:
            try:
                if args.trace:
                    from repro_torch.obs import export as obs_export

                    obs_export.enable_fleet(net)
                if args.metrics_port is not None:
                    from repro_torch.obs.metrics import MetricsExporter

                    exporter = MetricsExporter(net=net, port=args.metrics_port).start()
                    print(f"metrics: {exporter.url}", flush=True)
                    report["metrics_url"] = exporter.url
                if args.timeline:
                    from repro_torch.obs.sampler import FleetSampler
                    from repro_torch.obs.timeseries import TimelineWriter

                    timeline = TimelineWriter(args.timeline, pattern="*", interval=0.25,
                                              meta={"launcher": "train", "arch": args.arch})
                    tl_sampler = FleetSampler(pattern="*", interval=0.25, net=net,
                                              timeline=timeline)
                    tl_sampler.sample_once()  # t=0 baseline record
                    tl_sampler.start()
                cfg = get_config(args.arch, smoke=args.smoke)
                plan = get_plan(args.plan, **({"microbatches": args.microbatches}
                                              if args.plan != "bsp" and args.microbatches > 1
                                              else {}))
                model = build_model(cfg, device, plan=plan)
                dcfg = DataConfig(batch_size=args.batch, seq_len=args.seq)
                prefetcher = None
                if args.sharded_rows > 0:
                    before = _wire_bytes(net)
                    ds = ShardedTokenDataset.create("/data/train-shard", cfg, dcfg,
                                                    rows=args.sharded_rows,
                                                    device=device.type)
                    prefetcher = ds.feeder()
                    line = {"sharded_rows": len(ds),
                            "local_rows": int(prefetcher.global_rows.shape[0]),
                            "segments": ds.pv.nsegments,
                            "wire_bytes": _wire_bytes(net) - before}
                    print(json.dumps(line))
                    report["sharded"] = line
                    report["feeder"] = prefetcher
                trainer = Trainer(
                    model,
                    AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                                total_steps=args.steps),
                    dcfg,
                    TrainConfig(steps=args.steps, log_every=args.log_every,
                                ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir),
                    device=device, prefetcher=prefetcher,
                )
                if args.resume:
                    print(f"resumed at step {trainer.resume()}")
                history = trainer.fit()
                for h in history:
                    print(json.dumps(h))
                report["history"] = history
                counters = dict(core.counters.query("/train*"))
                print(json.dumps({"counters": counters}))
                report["counters"] = counters
                if args.trace:
                    tr = obs_export.export_chrome_trace(args.trace, net=net)
                    print(json.dumps({"trace": args.trace,
                                      "events": len(tr["traceEvents"])}))
                    report["trace_events"] = len(tr["traceEvents"])
                if args.print_counters:
                    from repro_torch.obs import sampler as obs_sampler

                    obs_sampler.print_counter_report(args.print_counters, net=net)
                if timeline is not None:
                    tl_sampler.stop()
                    tl_sampler.sample_once()  # end-of-run record (≥2 guaranteed)
                    timeline.close()
                    report["timeline"] = {"timeline": args.timeline,
                                          "records": timeline.records_written,
                                          "stride": timeline.stride}
                    print(json.dumps(report["timeline"]))
            finally:
                if tl_sampler is not None:
                    tl_sampler.stop()
                if timeline is not None:
                    timeline.close()
                if exporter is not None:
                    exporter.close()
                if trainer is not None:
                    trainer.close()  # AGAS holds the state until then
    finally:
        core.finalize()
    return report


if __name__ == "__main__":
    main()
