"""Attention backward's share of its roofline in one profiled training
step: the device time of everything launched inside the autograd
node's range (``_FlashTrainableBackward``: its math, or a kernel that
later takes its place under the same node), against the bound of each
call (``work.attn_bwd`` at the microbatch's shape)."""

from perfbench import work
from perfbench.profiling import device_time_within


def read(rec):
    p = rec.profile
    if p is None:
        return None
    busy, n = device_time_within(p, "_FlashTrainableBackward")
    if not n or not busy:
        return None
    s = rec.shape
    one = work.bound_s(*work.attn_bwd(rec.rows // rec.microbatches, rec.seq, s["num_heads"],
                                      s["num_kv_heads"], s["head_dim"], s["causal"]), rec.peaks)
    return n * one / busy * 100
