"""The paged decode kernel's share of its roofline in the profiled
stretch, over the decode steps that lie wholly inside it: each step's
bound is, in every layer, the live K/V bytes at the lengths of the
step's rows (each live row's prompt and tokens so far, as the client saw
the step produce them; each idle row one position), with q, the output
and the page-table entries, over the bandwidth (``work.paged_decode``);
the time is the device time of the decode kernels
(``repro_torch::decode::``) that start between the first such step's
start and the last one's end: a step ends in the host's read of its
tokens, so its kernels have run by then, and the serving cells run no
other decode kernel."""

from perfbench import work


def read(rec):
    p = rec.profile
    if p is None:
        return None
    steps = [(p.to_ns(a), p.to_ns(b), ls) for a, b, ls in rec.decode_lengths]
    steps = [s for s in steps if p.t0_ns <= s[0] and s[1] <= p.t1_ns]
    if not steps:
        return None
    lo, hi = steps[0][0], steps[-1][1]
    busy = sum(b - a for name, a, b, _ in p.device
               if "repro_torch::decode::" in name and lo <= a <= hi) / 1e9
    s = rec.shape
    bound = sum(work.bound_s(*work.paged_decode(ls + [1] * max(rec.rows - len(ls), 0),
                                                s["num_heads"], s["num_kv_heads"],
                                                s["head_dim"], rec.page_size), rec.peaks)
                for _, _, ls in steps) * s["num_layers"]
    return bound / busy * 100 if busy else None
