"""Config system: architecture configs and the registry.

Each ported architecture lives in ``repro_torch/configs/<id>.py`` exposing
``full_config()`` (the exact published dims) and ``smoke_config()`` (a
reduced same-family config for CPU tests).  ``ModelConfig`` copies the
reference's fields, so the two packages describe a model the same way,
except the reference's ``attn_impl`` switch, which is gone: the port's
attention always goes through :mod:`repro_torch.kernels.ops`, which runs
the CUDA kernel on a CUDA tensor and the plain version on a CPU tensor.

The registry lists every architecture of the reference (each family is
ported); an unknown arch raises a ``KeyError``.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention / embedding flags
    qkv_bias: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu | gelu
    glu: bool = True  # gated MLP (SwiGLU/GeGLU) vs plain 2-layer
    causal: bool = True
    window: int = 0  # >0: sliding-window (local) attention
    learned_pos: bool = False  # learned absolute positions (whisper decoder)
    max_position: int = 0  # size of learned position table (0 = max seq)
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    first_dense: int = 0  # leading dense FFN layers (DeepSeekMoE)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    dense_d_ff: int = 0  # d_ff for the leading dense layers / shared experts base
    # SSM (Mamba-2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    # Hybrid (RecurrentGemma / Griffin)
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    # Enc-dec (Whisper)
    enc_layers: int = 0
    dec_layers: int = 0
    # VLM (InternVL2)
    n_patches: int = 0
    # numerics / kernels
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 128 so the TP axis always divides it (embedding
        tables and logits shard on every mesh; padded logit columns are
        masked to -inf in ``unembed`` — exact semantics preserved)."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this family decode at 500k context? SSM: O(1) state.
        Hybrid: O(window) local attention + O(1) recurrent state."""
        return self.family in ("ssm", "hybrid")

    @property
    def moe_layer_count(self) -> int:
        return self.num_layers - self.first_dense if self.is_moe else 0


@dataclass(frozen=True)
class ShapeCell:
    """One assigned (input shape) cell of the dry run."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


# every architecture of the reference, in its order
ARCH_IDS: List[str] = [
    "whisper_small", "mamba2_780m", "qwen25_3b", "starcoder2_3b", "granite_34b",
    "starcoder2_15b", "deepseek_moe_16b", "granite_moe_3b_a800m", "recurrentgemma_2b",
    "internvl2_2b",
]

# architectures of the reference that later slices of the port bring over
NOT_PORTED: List[str] = []

# accept dashed spellings on the CLI
_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS + NOT_PORTED}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    arch = _ALIASES.get(arch, arch)
    if arch in NOT_PORTED:
        raise KeyError(f"arch {arch!r} is not ported yet; ported: {ARCH_IDS}")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.smoke_config() if smoke else mod.full_config()


def cells_for(cfg: ModelConfig) -> List[str]:
    """The shape cells that apply to an arch: long_500k needs a
    sub-quadratic family."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        cells.append("long_500k")
    return cells


def all_cells() -> List[Tuple[str, str]]:
    """Every live (arch, shape) cell of the dry run."""
    return [(arch, cell) for arch in ARCH_IDS for cell in cells_for(get_config(arch))]
