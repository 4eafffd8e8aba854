"""Elastic scaling & fault tolerance with the PyTorch port: AGAS migration
across device meshes.

    PYTHONPATH=src python examples/elastic_migration_torch.py            # 8 gloo ranks on the CPU
    PYTHONPATH=src python examples/elastic_migration_torch.py --device cuda   # one rank per card (8 cards)

Eight ranks (spawned processes, SPMD: each builds the same meshes):

1. Train the smoke starcoder2_3b on a 4×2 (data, model) mesh (FSDP over
   'data'), and checkpoint it asynchronously.
2. Simulate losing three quarters of the fleet → ``elastic_restart`` moves
   the live params and optimizer state onto a 2×1 mesh (same GID, bumped
   generation) and training goes on there; the other ranks sit out.
3. 'Repair' the fleet → restore the checkpoint onto an 8×1 mesh (elastic
   restart across a different topology).
"""
import argparse
import os
import sys
import tempfile

import torch
import torch.multiprocessing as mp

WORLD = 8


def _rank(rank: int, args: argparse.Namespace, store: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)  # eight ranks on a few cores: one thread each

    import repro_torch.core as core
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.core import agas
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.dist.plan import get_plan
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    mesh_mod.init_process_group(rank, WORLD, args.device, store_path=store, timeout_s=120)
    core.init(num_workers=2)
    try:
        device = f"cuda:{rank}" if args.device == "cuda" else "cpu"
        say = print if rank == 0 else (lambda *a, **k: None)
        cfg = get_config("starcoder2_3b", smoke=True)
        model = Model(cfg, device, plan=get_plan("futurized"))
        mesh4 = mesh_mod.make_mesh_shape((4, 2), ("data", "model"), args.device)
        mesh2 = mesh_mod.make_mesh_shape((2, 1), ("data", "model"), args.device)
        mesh8 = mesh_mod.make_mesh_shape((8, 1), ("data", "model"), args.device)

        trainer = Trainer(model, AdamWConfig(lr=1e-3, total_steps=60),
                          DataConfig(batch_size=8, seq_len=32),
                          TrainConfig(steps=args.steps, log_every=max(1, args.steps // 2),
                                      ckpt_dir=args.ckpt_dir),
                          device=device, mesh=mesh4)
        h1 = trainer.fit(args.steps)
        say(f"[mesh 4x2] {args.steps} steps, loss {h1[-1]['loss']:.3f}")
        say("placement:", next(iter(trainer.params.values())).placements)
        ck = trainer.checkpoint_async()

        # --- simulate node failure: shrink to 2 ranks -----------------------
        rec_before = agas.default().record(trainer.gid)
        gen_before = rec_before.generation
        trainer.elastic_restart(mesh2)
        h2 = trainer.fit(args.steps)  # ranks 2-7 hold no state and step nothing
        rec_after = agas.default().record(trainer.gid)
        if h2:
            say(f"[mesh 2x1] survived failure: {args.steps} more steps, loss "
                f"{h2[-1]['loss']:.3f}")
        say(f"AGAS gid stable: {rec_before.gid == rec_after.gid}, "
            f"generation {gen_before} → {rec_after.generation}")

        # --- fleet repaired: restore the checkpoint onto 8 ranks -------------
        ck.get()
        dist.barrier()  # the writing rank is done
        step, state = ckpt.restore(args.ckpt_dir, shardings=trainer.shardings(mesh8),
                                   mesh=mesh8)
        say(f"[mesh 8x1] checkpoint from step {step} restored onto 8 ranks; "
            f"placement: {next(iter(state['params'].values())).placements}")
        trainer.close()
    finally:
        core.finalize()
        mesh_mod.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--ckpt-dir", default="checkpoints/elastic")
    args = ap.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < WORLD:
        sys.exit(f"--device cuda needs {WORLD} cards (one rank per card; NCCL puts no "
                 f"two ranks on one); this host has {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_rank, args=(args, os.path.join(d, "store")), nprocs=WORLD, join=True)


if __name__ == "__main__":
    main()
