"""Configuration dataclasses (copy of ``repro/config.py``).

Every model served by the port is described by a frozen
``ModelConfig``; architectures live in ``repro_torch.configs``.  The
port keeps its own copy so that it imports nothing of ``repro``: the
model configs, the tensor-parallel head geometry (``TPGeometry``), the
four assigned input shapes (``SHAPES``) and the production mesh
(``MeshConfig``, the geometry ``launch/mesh.make_production_mesh``
builds) that the lowering tools read.  The TPU hardware constants are left out.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

# KV-cache pool granularity: one head-wise block holds BLOCK_TOKENS tokens
# of a single KV head (paper §3.4: "each block holds the KV cache of one
# head for several tokens").
BLOCK_TOKENS = 16


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden size
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int                   # N — SSM state size
    head_dim: int = 64             # P — channels per SSM head
    expand: int = 2                # d_inner = expand * d_model
    conv_kernel: int = 4
    chunk_size: int = 256          # Q — SSD chunk length
    n_groups: int = 1              # B/C groups


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 → d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None   # decode-time window (long_500k)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid layout: an attention block is applied after every
    # ``attn_every`` SSM layers (0 → no attention at all, pure SSM).
    attn_every: int = 0
    shared_attn: bool = False      # Zamba2-style: one shared attn block
    # modality frontend stub: number of embedding-input channels.  When
    # not None the model accepts precomputed frame/patch embeddings of
    # shape [batch, n_prefix, frontend_dim] in addition to tokens.
    frontend_dim: Optional[int] = None
    n_prefix_tokens: int = 0
    source: str = ""               # citation

    # ---- derived ---------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def n_attn_layers(self) -> int:
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            if self.attn_every <= 0:
                return 0
            return self.n_layers // self.attn_every
        return self.n_layers

    @property
    def n_ssm_layers(self) -> int:
        if self.family == "ssm":
            return self.n_layers
        if self.family == "hybrid":
            return self.n_layers
        return 0

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim if self.ssm else 0

    def param_count(self) -> int:
        """Analytic parameter count (exact for our implementation)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.hd
        n_emb = v * d * (1 if self.tie_embeddings else 2)
        per_attn = d * (self.n_heads * hd) + d * (2 * self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.qkv_bias:
            per_attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        if self.qk_norm:
            per_attn += 2 * hd
        per_mlp = 3 * d * f
        if self.moe:
            per_mlp = self.moe.n_experts * 3 * d * self.moe.d_expert \
                + d * self.moe.n_experts
        per_ssm = 0
        if self.ssm:
            di, N, H = self.d_inner, self.ssm.d_state, self.n_ssm_heads
            G = self.ssm.n_groups
            in_proj = d * (2 * di + 2 * G * N + H)
            conv = (di + 2 * G * N) * self.ssm.conv_kernel
            out = di * d
            per_ssm = in_proj + conv + out + 3 * H + di  # A, D, dt_bias, gnorm
        total = n_emb + 2 * d  # final norm (w only; +d slack)
        if self.family == "ssm":
            total += L * (per_ssm + d)
        elif self.family == "hybrid":
            total += L * (per_ssm + d)
            n_attn = self.n_attn_layers if not self.shared_attn else 1
            total += n_attn * (per_attn + per_mlp + 2 * d)
        else:
            total += L * (per_attn + per_mlp + 2 * d)
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.moe:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        dense = self.param_count() - L * self.moe.n_experts * 3 * d * self.moe.d_expert
        return int(dense + L * self.moe.top_k * 3 * d * self.moe.d_expert)

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KV-cache bytes per token (logical, un-padded)."""
        return 2 * self.n_attn_layers * self.n_kv_heads * self.hd * dtype_bytes

    def weight_bytes(self, dtype_bytes: int = 2) -> int:
        return self.param_count() * dtype_bytes


@dataclass(frozen=True)
class TPGeometry:
    """Padded attention geometry for an exact tensor-parallel layout.

    ``kv_padded = n_kv * 16/gcd(n_kv,16)`` is divisible by ``tp``;
    each physical kv head appears ``rep`` times.  Query heads are padded
    so every kv-head replica carries the same number of query heads.
    Padding cost is real compute/memory waste and is surfaced in the
    roofline's useful-FLOPs ratio (DESIGN.md §2).
    """
    tp: int
    n_heads: int          # logical q heads
    n_kv_heads: int       # logical kv heads
    h_padded: int         # padded q heads (divisible by tp and kv_padded)
    kv_padded: int        # padded/replicated kv heads (divisible by tp)
    rep: int              # kv replication factor
    q_per_rank: int
    kv_per_rank: int
    group: int            # q heads per padded kv head


def tp_geometry(n_heads: int, n_kv_heads: int, tp: int = 16) -> TPGeometry:
    g = math.gcd(n_kv_heads, tp)
    rep = tp // g
    kv_padded = n_kv_heads * rep
    group_logical = n_heads // n_kv_heads
    group = max(1, math.ceil(group_logical / rep))
    h_padded = kv_padded * group
    # ensure divisibility by tp (kv_padded already divisible by tp)
    assert kv_padded % tp == 0 and h_padded % tp == 0
    return TPGeometry(
        tp=tp, n_heads=n_heads, n_kv_heads=n_kv_heads,
        h_padded=h_padded, kv_padded=kv_padded, rep=rep,
        q_per_rank=h_padded // tp, kv_per_rank=kv_padded // tp,
        group=group,
    )


def pad_vocab(v: int, multiple: int = 256) -> int:
    return ((v + multiple - 1) // multiple) * multiple


# ---------------------------------------------------------------------------
# input shapes (assigned)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False

    @property
    def shape(self) -> Tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def dp(self) -> int:       # total data-parallel ways (pod × data)
        return self.n_devices // 16

    @property
    def tp(self) -> int:
        return 16


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
