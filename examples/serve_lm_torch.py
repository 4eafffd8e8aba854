"""Batched serving on the port's paged continuous-batching stack, on the
GPU unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/serve_lm_torch.py                  # one process
    PYTHONPATH=src python examples/serve_lm_torch.py --localities 2   # two processes
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

As ``examples/serve_lm.py``: requests are submitted as futures
(one-sided, HPX semantics); prefill runs as PRIORITY_HIGH tasks overlapped
with the decode continuation chain, KV lives in a block-pool paged cache
(the paged decode kernel reads it on the card), and every request streams
its tokens through a ``core.Channel`` as the slots advance.  Engine
replicas sit behind the least-loaded router.

With ``--localities 2`` the replicas are real OS processes: locality 0
(this process, the AGAS root) serves alongside a worker locality reached
over the parcelport, each with its own CUDA context on the card.  Remote
submissions return plain futures (token channels are per-process), and
per-locality token counters are read back across the wire at the end —
both localities serve.

``main(argv)`` returns the run's outputs (prompts, tokens, per-locality
token counts) for in-process callers.
"""
import argparse
import time

import numpy as np

import repro_torch.core as core
from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.dist.plan import get_plan
from repro_torch.models.model import build_model
from repro_torch.serve.engine import SamplingParams, ServeConfig
from repro_torch.serve.router import Router


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--localities", type=int, default=1,
                    help=">1 spreads engines over OS-process localities")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # raises without CUDA, before any spawn

    scfg = ServeConfig(max_batch=4, cache_len=128, max_new_tokens=12)
    cfg = get_config("qwen25_3b", smoke=True)
    if args.localities > 1:
        from repro_torch import net as tnet

        pools = {"default": 4, "prefill": 2, "io": 1}
        net = tnet.bootstrap(args.localities, pools=pools, worker_pools=pools)
        router = Router.over_localities(net, "qwen25_3b", scfg, smoke=True,
                                        device=args.device)
    else:
        net = None
        core.init(num_workers=4)
        model = build_model(cfg, args.device, plan=get_plan("futurized"))
        params = model.init(0)
        router = Router.replicate(model, params, scfg, replicas=2, device=model.device)

    rng = np.random.default_rng(0)
    hot = SamplingParams(temperature=0.8, top_k=40, top_p=0.95)
    report = {"requests": []}

    def generated(i):  # engine#i's tokens so far (the counter outlives an engine)
        return sum(v for _, v in core.counters.query(f"/serve{{engine#{i}}}/tokens/generated"))

    t0 = time.perf_counter()
    if net is None:
        before = [generated(i) for i in range(2)]
        streams = []
        for i in range(10):  # 10 requests, 2×4 slots → continuous batching
            prompt = rng.integers(1, cfg.vocab_size, size=rng.integers(3, 24)).tolist()
            # even requests greedy, odd requests sampled
            sp = hot if i % 2 else SamplingParams()
            streams.append((prompt, sp, *router.submit_stream(prompt, sampling=sp)))
        for prompt, sp, ch, fut in streams:
            toks = list(ch)  # arrives token-by-token as the slot advances
            out = fut.get(timeout=600)
            assert toks == out
            mode = "sampled" if sp.temperature > 0 else "greedy "
            print(f"{mode} prompt[{len(prompt):2d} toks] → {out}")
            report["requests"].append((prompt, sp.temperature, out))
        dt = time.perf_counter() - t0
        per_engine = {f"engine#{i}": generated(i) - before[i] for i in range(2)}
        total = int(sum(per_engine.values()))
        print(f"\n10 requests, {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s)")
        print("dispatch:", dict(core.counters.query("/serve{router}/dispatch/*")))
        print("pages in use:",
              dict(core.counters.query("/serve{engine#*}/pages/in_use")))
        report["tokens_by_engine"] = per_engine
        for e in router.engines:
            e.close()
    else:
        from repro_torch import net as tnet

        # mixed batch: greedy and sampled prompts, futures only (one-sided)
        futures = []
        for i in range(12):
            prompt = rng.integers(1, cfg.vocab_size, size=rng.integers(3, 24)).tolist()
            sp = hot if i % 2 else SamplingParams()
            futures.append((prompt, sp, router.submit(prompt, sampling=sp)))
        total = 0
        for prompt, sp, fut in futures:
            out = fut.get(timeout=600)
            total += len(out)
            mode = "sampled" if sp.temperature > 0 else "greedy "
            print(f"{mode} prompt[{len(prompt):2d} toks] → {out}")
            report["requests"].append((prompt, sp.temperature, out))
        dt = time.perf_counter() - t0
        print(f"\n12 requests, {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s)")
        print("dispatch:", dict(core.counters.query("/serve{router}/dispatch/*")))
        per_loc = {}
        for loc in range(args.localities):
            toks = dict(tnet.query_counters(loc, "/serve{engine*}/tokens/generated"))
            per_loc[f"locality#{loc}"] = sum(toks.values())
        print("tokens by locality:", per_loc)
        assert all(v > 0 for v in per_loc.values()), \
            "every locality should have served tokens"
        report["tokens_by_locality"] = per_loc
        net.shutdown()
    report["seconds"] = dt
    core.finalize()
    return report


if __name__ == "__main__":
    main()
