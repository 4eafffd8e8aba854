"""End-to-end example of the PyTorch port: train a ~100M-parameter LM with
the futurized trainer, on the GPU unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200          # ~100M
    PYTHONPATH=src python examples/train_lm_torch.py --tiny --steps 60 --device cpu

Demonstrates the port's stack: AMT runtime → prefetching data pipeline →
train step (the flash kernel as the attention forward, AdamW in place) →
async checkpointing → performance counters.
"""
import argparse
import json
import math
import time

import repro_torch.core as core
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.dist.plan import get_plan
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer


def config_100m() -> ModelConfig:
    """~110M params: a llama-style dense decoder."""
    return ModelConfig(
        name="demo_100m", family="dense",
        num_layers=12, d_model=640, num_heads=10, num_kv_heads=2,
        head_dim=64, d_ff=2560, vocab_size=50304, rope=True,
    )


def config_tiny() -> ModelConfig:
    return ModelConfig(
        name="demo_tiny", family="dense",
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=512, vocab_size=2048, rope=True,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm_torch")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    core.init(num_workers=4)
    cfg = config_tiny() if args.tiny else config_100m()
    model = build_model(cfg, args.device, plan=get_plan("futurized"))
    n = sum(math.prod(s.shape) for s in model.param_specs().values())
    print(f"model: {cfg.name}  params={n / 1e6:.1f}M  device={model.device}")

    trainer = Trainer(
        model,
        AdamWConfig(lr=3e-3, warmup_steps=max(args.steps // 10, 1),
                    total_steps=args.steps, weight_decay=0.01),
        DataConfig(batch_size=args.batch, seq_len=args.seq, prefetch=2),
        TrainConfig(steps=args.steps, log_every=10,
                    ckpt_every=max(args.steps // 4, 1), ckpt_dir=args.ckpt_dir),
        device=model.device,
    )
    t0 = time.time()
    history = trainer.fit()
    dt = time.time() - t0
    for h in history:
        print(json.dumps(h))
    tokens = args.steps * args.batch * args.seq
    print(f"\n{args.steps} steps / {tokens} tokens in {dt:.1f}s "
          f"({tokens / dt:.0f} tok/s on {model.device})")
    print("first→last loss:", history[0]["loss"], "→", history[-1]["loss"])
    print("counters:", json.dumps(dict(core.counters.query("/train*")), indent=1))
    core.finalize()


if __name__ == "__main__":
    main()
