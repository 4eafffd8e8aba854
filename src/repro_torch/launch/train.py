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

Every family trains: dense, moe (its router aux loss in the objective),
vlm (no loss on the image positions), ssm and hybrid (their scans
through the trainable ops) and encdec (the encoder over ``enc`` frames,
one per decoder position, as the reference's synthetic batches carry).

The reference's fleet, trace-export, metrics and timeline flags
(``--localities``, ``--sharded-rows``, ``--trace``, ``--print-counters``,
``--metrics-port``, ``--timeline``) come with the multi-locality runtime.
"""

from __future__ import annotations

import argparse
import json
import os


def main() -> None:
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
    args = ap.parse_args()

    # Set before CUDA starts: the caching allocator then grows segments in
    # place instead of keeping freed blocks of fixed-size segments apart.
    # Without it a 16,384-token step of granite_moe_3b_a800m (~69 GiB live
    # at its peak on an 80 GB card) finds its reserved memory split too
    # finely for its 3.75 GiB stacked expert gradients.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

    import repro_torch.core as core
    from repro_torch._device import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.dist.plan import get_plan
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    device = resolve_device(args.device)  # raises without CUDA
    cfg = get_config(args.arch, smoke=args.smoke)
    plan = get_plan(args.plan, **({"microbatches": args.microbatches}
                                  if args.plan != "bsp" and args.microbatches > 1 else {}))
    model = build_model(cfg, device, plan=plan)
    # Resource partition: compute-plane tasks on "default", prefetch
    # assembly and checkpoint writes on the single-worker "io" pool.
    core.init(policy=args.scheduler, pools={"default": args.workers, "io": 1})
    try:
        trainer = Trainer(
            model,
            AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                        total_steps=args.steps),
            DataConfig(batch_size=args.batch, seq_len=args.seq),
            TrainConfig(steps=args.steps, log_every=args.log_every,
                        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir),
            device=device,
        )
        if args.resume:
            print(f"resumed at step {trainer.resume()}")
        history = trainer.fit()
        for h in history:
            print(json.dumps(h))
        print(json.dumps({"counters": dict(core.counters.query("/train*"))}))
    finally:
        core.finalize()


if __name__ == "__main__":
    main()
