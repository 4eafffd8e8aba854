"""The flash forward's share of its roofline in the profiled stretch,
counted on the prompts' valid tokens and not on the bucket's padding:
each ``repro_torch::flash_attention`` call made in the stretch is bound
by one ``work.flash_fwd`` at its prefill's ``prompt_len`` (causal pairs,
inputs read once, the output written once; the larger of operations over
the bf16 peak and bytes over the bandwidth), over the device time of the
operations that the call launched.  A call belongs to the ``prefill``
span that holds it on the call's own thread, so a prefill that the
stretch cuts counts with the layers that lie inside it, and prefills
that overlap on the pool's workers are told apart.  The profiler and the
program's spans number threads differently: a profiler thread is the
worker whose span alone holds some of its calls, or else the one worker
left.  In the serving cells only prefills call the flash forward."""

from collections import Counter

from perfbench import work

OP = "repro_torch::flash_attention"


def read(rec):
    p = rec.profile
    if p is None:
        return None
    by_op = {}
    for _, a, b, c in p.device:
        by_op[c] = by_op.get(c, 0) + (b - a)
    spans = [(p.to_ns(a), p.to_ns(b), args["thread"], int(args["prompt_len"]))
             for name, a, b, args in rec.spans if name == "prefill"]
    calls = [(a, th, corr) for name, a, _, th, corr, _ in p.host if name == OP and corr in by_op]

    def around(t):
        return [sp for sp in spans if sp[0] <= t <= sp[1]]

    votes = {}
    for t, th, _ in calls:
        held = around(t)
        if len(held) == 1:
            votes.setdefault(th, Counter())[held[0][2]] += 1
    worker = {th: v.most_common(1)[0][0] for th, v in votes.items()}
    left = {sp[2] for sp in spans} - set(worker.values())
    unmapped = {th for _, th, _ in calls} - set(worker)
    if len(unmapped) == 1 and len(left) == 1:
        worker[unmapped.pop()] = left.pop()
    s = rec.shape
    bound = busy = 0.0
    for t, th, corr in calls:
        mine = [sp for sp in around(t) if sp[2] == worker.get(th)]
        if len(mine) != 1:
            continue
        bound += work.bound_s(*work.flash_fwd(1, mine[0][3], s["num_heads"], s["num_kv_heads"],
                                              s["head_dim"], s["causal"]), rec.peaks)
        busy += by_op[corr] / 1e9
    return bound / busy * 100 if busy else None
