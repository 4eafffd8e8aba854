"""The benchmark's own count of the work: model FLOPs of a prefill and of
a training step, and the bound of each kernel whose share of its roofline
the benchmark reads.  It counts from the shapes alone, whatever
implements them, so a kernel's roofline reads the same work before and
after a change to the program.

``shape`` holds a configuration's sizes under the port's field names
(``d_model``, ``num_layers``, ``num_heads``, ``num_kv_heads``,
``head_dim``, ``d_ff``, ``vocab_size``, ``glu``; for a mixture of experts
``n_experts``, ``top_k``, ``n_shared_experts``, ``first_dense``,
``dense_d_ff``), as ``harness.load_config`` builds it.  Matrix products
count 2 operations a multiply-add; biases, norms, activations and the
softmax are not counted.  A mixture of experts counts the experts each
token activates (``top_k`` routed and the shared ones), never the
padding rows of a capacity buffer.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

BF16_BYTES = 2


def _attn_proj(shape: Dict) -> int:
    D, H, KV, Dh = (shape[k] for k in ("d_model", "num_heads", "num_kv_heads", "head_dim"))
    return 2 * (D * H * Dh + 2 * D * KV * Dh + H * Dh * D)


def _mlp(shape: Dict, d_ff: int) -> int:
    return 2 * shape["d_model"] * d_ff * (3 if shape["glu"] else 2)


def _moe(shape: Dict) -> int:
    D, E, k, F = (shape[n] for n in ("d_model", "n_experts", "top_k", "d_ff"))
    shared = shape.get("n_shared_experts", 0) * F
    return 2 * D * E + k * 2 * 3 * D * F + (2 * 3 * D * shared if shared else 0)


def linear_flops_per_token(shape: Dict) -> int:
    """Operations of every layer's projections and feed-forward for one
    token (the attention scores and the unembedding apart)."""
    L, fd = shape["num_layers"], shape.get("first_dense", 0)
    if shape.get("n_experts", 0):
        dense = fd * (_attn_proj(shape) + _mlp(shape, shape["dense_d_ff"]))
        return dense + (L - fd) * (_attn_proj(shape) + _moe(shape))
    return L * (_attn_proj(shape) + _mlp(shape, shape["d_ff"]))


def causal_pairs(n: int) -> int:
    """(query, key) pairs of causal attention over ``n`` positions."""
    return n * (n + 1) // 2


def attention_flops(shape: Dict, pairs: int) -> int:
    """Scores and weighted values over ``pairs`` (query, key) pairs in
    every layer: 4 · head_dim · heads a pair."""
    return shape["num_layers"] * 4 * shape["head_dim"] * shape["num_heads"] * pairs


def unembed_flops(shape: Dict, positions: int) -> int:
    return 2 * shape["d_model"] * shape["vocab_size"] * positions


def prefill_flops(shape: Dict, n: int) -> int:
    """A prefill of ``n`` valid prompt tokens: every token through every
    layer, causal attention among them, logits at the last position."""
    return (n * linear_flops_per_token(shape) + attention_flops(shape, causal_pairs(n))
            + unembed_flops(shape, 1))


def train_step_flops(shape: Dict, rows: int, seq: int) -> int:
    """A training step over ``rows`` sequences of ``seq`` predicted
    tokens: the forward with logits at every position, and the backward
    at twice the forward; no recomputation."""
    fwd = (seq * linear_flops_per_token(shape) + attention_flops(shape, causal_pairs(seq))
           + unembed_flops(shape, seq))
    return 3 * rows * fwd


def flash_fwd(B: int, S: int, H: int, KV: int, Dh: int, causal: bool = True
              ) -> Tuple[int, int]:
    """(operations, bytes) of one flash forward: the unmasked pairs'
    scores and values; q, k and v read once and the output written once,
    in bf16."""
    pairs = causal_pairs(S) if causal else S * S
    flops = 4 * Dh * H * B * pairs
    nbytes = BF16_BYTES * B * S * Dh * (2 * H + 2 * KV)
    return flops, nbytes


def attn_bwd(B: int, S: int, H: int, KV: int, Dh: int, causal: bool = True
             ) -> Tuple[int, int]:
    """(operations, bytes) of one attention backward from q, k, v and the
    output's gradient: the scores again, then dV, dP, dQ and dK, five
    products over the unmasked pairs (2.5 times the forward); q, k, v and
    dO read once, dQ, dK and dV written once, in bf16."""
    pairs = causal_pairs(S) if causal else S * S
    flops = 10 * Dh * H * B * pairs
    nbytes = BF16_BYTES * B * S * Dh * ((2 * H + 2 * KV) + (H + 2 * KV))
    return flops, nbytes


def paged_decode(lengths: Iterable[int], H: int, KV: int, Dh: int, page: int
                 ) -> Tuple[int, int]:
    """(operations, bytes) of one paged decode call: each row reads its
    live keys and values once (``length`` positions) and the page-table
    entries that hold them, reads its query and writes its output."""
    lengths = list(lengths)
    live = sum(lengths)
    flops = 4 * Dh * H * live
    nbytes = (BF16_BYTES * (2 * KV * Dh * live + 2 * H * Dh * len(lengths))
              + 4 * sum(-(-n // page) for n in lengths))
    return flops, nbytes


def bound_s(flops: float, nbytes: float, peaks: Dict[str, float]) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the memory bandwidth."""
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes"])
