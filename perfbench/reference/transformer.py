"""Decoder-only transformer forward, dense and mixture of experts, in
fp32, one layer at a time over a list of sequences.

``shape`` holds the sizes under the port's field names and ``ref`` the
extras (``norm_eps``, ``norm_topk_prob``); ``weights`` are the stacked
tensors the benchmark made: ``tok_embed`` (V, D), ``final_ln``,
``lm_head`` (D, V), and per stack (``d0/`` for the leading dense layers,
``blk/``) ``ln1``, ``wq``/``wk``/``wv`` (D, ·) with biases ``bq``/``bk``/
``bv`` where ``qkv_bias``, ``wo``, ``ln2``, and the FFN: ``w_in``,
``w_gate`` (gated), ``w_out``, or ``moe/router`` (D, E),
``moe/w_in``/``moe/w_gate`` (E, D, F), ``moe/w_out`` (E, F, D) and the
shared expert ``moe/shared_w_{in,gate,out}``.

``fp8=True`` is the control: every matrix product takes its operands
rounded to float8 e4m3 with one scale a tensor (amax / 448), the
precision below the configurations' bf16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def fp32_matmuls() -> None:
    """fp32 products stay fp32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def q8(x: torch.Tensor, fmt=torch.float8_e4m3fn, top: float = E4M3_MAX) -> torch.Tensor:
    """``x`` rounded to float8 with one scale for the tensor, back in fp32."""
    s = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / s).to(fmt).float() * s


class _MM8(torch.autograd.Function):
    """a @ b with e4m3 operands; the backward's products take the output
    gradient in e5m2, as fp8 training rounds it."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = q8(a), q8(b)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = q8(g, torch.float8_e5m2, E5M2_MAX)
        return g8 @ b8.transpose(-1, -2), a8.transpose(-1, -2) @ g8


def mm(a: torch.Tensor, b: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    return _MM8.apply(a, b) if fp8 else a @ b


def norm(shape: Dict, ref: Dict, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    if shape["norm"] == "rmsnorm":
        y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + ref["norm_eps"])
    else:
        mu = x.mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + ref["norm_eps"])
    return y * scale


def act(shape: Dict, x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh") if shape["act"] == "gelu" else F.silu(x)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half (NeoX) rotary embedding: x (S, heads, Dh), positions (S,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, fp8: bool = False,
              block: int = 1024) -> torch.Tensor:
    """Causal softmax attention, q (S, H, Dh), k/v (S, KV, Dh), the query
    heads in groups over the key heads → (S, H·Dh); queries in blocks."""
    S, H, Dh = q.shape
    KV = k.shape[1]
    g = H // KV
    kh = k.permute(1, 2, 0).repeat_interleave(g, dim=0)     # (H, Dh, S)
    vh = v.permute(1, 0, 2).repeat_interleave(g, dim=0)     # (H, S, Dh)
    out = []
    for s0 in range(0, S, block):
        qb = q[s0:s0 + block].permute(1, 0, 2)               # (H, b, Dh)
        s = mm(qb, kh, fp8) / math.sqrt(Dh)                  # (H, b, S)
        rows = torch.arange(s0, s0 + qb.shape[1], device=q.device)[:, None]
        s = s.masked_fill(torch.arange(S, device=q.device)[None, :] > rows, float("-inf"))
        out.append(mm(torch.softmax(s, dim=-1), vh, fp8).permute(1, 0, 2))
    return torch.cat(out, dim=0).reshape(S, H * Dh)


def layer(weights: Dict[str, torch.Tensor], prefix: str, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i`` of a stack, in fp32."""
    return {k[len(prefix):]: v[i].float() for k, v in weights.items() if k.startswith(prefix)}


def capacity(shape: Dict, assignments: int) -> int:
    """The port's slots an expert for ``assignments`` (token, expert)
    pairs in one group: max(int(cf · A / E), min(A, 16), 1)."""
    A = assignments
    return max(int(shape["capacity_factor"] * A / shape["n_experts"]), min(A, 16), 1)


def decode_capacity(shape: Dict, rows: int) -> int:
    """C of a decode step over ``rows`` slots: a live row loses an expert
    only where C rows ahead of it chose that expert too."""
    return capacity(shape, rows * shape["top_k"])


def capacity_keep(shape: Dict, idx: torch.Tensor, n_valid: int, bucket: int) -> torch.Tensor:
    """The port's capacity rule on the first ``n_valid`` tokens of a
    prefill of ``bucket`` positions: an assignment is kept while fewer
    than C assignments to its expert come before it in token order (then
    the k choices of a token in order), C = max(int(cf · A / E),
    min(A, 16), 1) for the bucket's A = bucket · k assignments.  Tokens
    from ``n_valid`` on (served tokens) are all kept: a decode step's
    capacity is not the prefill's."""
    E, K = shape["n_experts"], shape["top_k"]
    C = capacity(shape, bucket * K)
    keep = torch.ones_like(idx, dtype=torch.bool)
    flat = idx[:n_valid].reshape(-1)
    onehot = F.one_hot(flat, E)
    rank = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
    keep[:n_valid] = (rank < C).reshape(n_valid, K)
    return keep


def moe(shape: Dict, ref: Dict, w: Dict[str, torch.Tensor], h: torch.Tensor,
        parts: Sequence[Tuple[int, Optional[Tuple[int, int]]]], fp8: bool) -> torch.Tensor:
    """The mixture-of-experts FFN over h (T, D), the tokens of several
    sequences one after another: ``parts`` gives each sequence's token
    count and its capacity rule (:func:`capacity_keep`'s arguments, or
    None to keep every assignment)."""
    probs = torch.softmax(mm(h, w["moe/router"], fp8), dim=-1)
    gw, idx = torch.topk(probs, shape["top_k"], dim=-1)
    if ref["norm_topk_prob"]:
        gw = gw / gw.sum(-1, keepdim=True)
    keep, at = [], 0
    for n, cap in parts:
        part = idx[at:at + n]
        keep.append(capacity_keep(shape, part, *cap) if cap is not None
                    else torch.ones_like(part, dtype=torch.bool))
        at += n
    keep = torch.cat(keep)
    y = torch.zeros_like(h)
    for e in torch.unique(idx[keep]).tolist():
        tok, j = torch.nonzero((idx == e) & keep, as_tuple=True)
        x = h[tok]
        ye = mm(act(shape, mm(x, w["moe/w_gate"][e], fp8)) * mm(x, w["moe/w_in"][e], fp8),
                w["moe/w_out"][e], fp8)
        y.index_add_(0, tok, ye * gw[tok, j][:, None])
    if shape.get("n_shared_experts", 0):
        y = y + mm(act(shape, mm(h, w["moe/shared_w_gate"], fp8)) * mm(h, w["moe/shared_w_in"], fp8),
                   w["moe/shared_w_out"], fp8)
    return y


def mlp(shape: Dict, w: Dict[str, torch.Tensor], h: torch.Tensor, fp8: bool) -> torch.Tensor:
    u = mm(h, w["w_in"], fp8)
    u = act(shape, mm(h, w["w_gate"], fp8)) * u if shape["glu"] else act(shape, u)
    return mm(u, w["w_out"], fp8)


def attend(shape: Dict, ref: Dict, w: Dict[str, torch.Tensor], x: torch.Tensor,
           fp8: bool) -> torch.Tensor:
    """x + self-attention over one sequence x (S, D)."""
    H, KV, Dh = shape["num_heads"], shape["num_kv_heads"], shape["head_dim"]
    S = x.shape[0]
    pos = torch.arange(S, device=x.device)
    h = norm(shape, ref, x, w["ln1"])
    q, k, v = (mm(h, w[f"w{n}"], fp8) for n in "qkv")
    if shape["qkv_bias"]:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = rope(q.reshape(S, H, Dh), pos, shape["rope_theta"])
    k = rope(k.reshape(S, KV, Dh), pos, shape["rope_theta"])
    return x + mm(attention(q, k, v.reshape(S, KV, Dh), fp8), w["wo"], fp8)


def ffn(shape: Dict, ref: Dict, w: Dict[str, torch.Tensor], x: torch.Tensor,
        moe_layer: bool, parts, fp8: bool) -> torch.Tensor:
    """x + the FFN half of a layer over tokens x (T, D) (see :func:`moe`
    for ``parts``)."""
    h = norm(shape, ref, x, w["ln2"])
    return x + (moe(shape, ref, w, h, parts, fp8) if moe_layer else mlp(shape, w, h, fp8))


def block(shape: Dict, ref: Dict, w: Dict[str, torch.Tensor], x: torch.Tensor,
          moe_layer: bool, fp8: bool) -> torch.Tensor:
    """One layer over one sequence x (S, D), every assignment kept."""
    x = attend(shape, ref, w, x, fp8)
    return ffn(shape, ref, w, x, moe_layer, [(x.shape[0], None)], fp8)


def stacks(shape: Dict) -> List[Tuple[str, int, bool]]:
    fd = shape.get("first_dense", 0)
    moe_model = bool(shape.get("n_experts", 0))
    return ([("d0/", fd, False)] if fd else []) + [("blk/", shape["num_layers"] - fd, moe_model)]


@torch.no_grad()
def logits_at(shape: Dict, ref: Dict, weights: Dict[str, torch.Tensor],
              seqs: Sequence[torch.Tensor], positions: Sequence[torch.Tensor],
              capacities: Sequence[Optional[Tuple[int, int]]], fp8: bool = False
              ) -> List[torch.Tensor]:
    """fp32 logits (len(positions[i]), vocab_size) of each sequence at the
    given positions, the sequences' layers run one layer at a time (each
    layer's weights made fp32 once).  ``capacities[i]`` is (valid prompt
    tokens, prefill bucket) for the mixture of experts' rule, or None."""
    emb = weights["tok_embed"]
    xs = [emb[s.long()].float() for s in seqs]
    parts = [(x.shape[0], c) for x, c in zip(xs, capacities)]
    for prefix, L, moe_layer in stacks(shape):
        for i in range(L):
            w = layer(weights, prefix, i)
            xs = [attend(shape, ref, w, x, fp8) for x in xs]
            y = ffn(shape, ref, w, torch.cat(xs), moe_layer, parts, fp8)
            xs = list(torch.split(y, [n for n, _ in parts]))
            del w, y
    head = weights["lm_head"].float()
    V = shape["vocab_size"]
    return [mm(norm(shape, ref, x[p.long()], weights["final_ln"].float()), head, fp8)[:, :V]
            for x, p in zip(xs, positions)]
