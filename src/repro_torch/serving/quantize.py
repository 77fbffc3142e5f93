"""Weight-only + KV-cache int8 quantization for serving (port of
``repro/serving/quantize.py``).

Per-channel symmetric int8 weights halve the weight footprint and int8
KV halves the decode's cache traffic.  Quantization is per OUTPUT
channel (the last axis), so dequantization commutes with the matmul:
``(x @ Wq)·s == x @ (Wq·s)``.

Plain tensor functions with the JAX package's names and rounding: the
same int8 values and float32 scales on the same inputs.  The
per-layer weight products stay ``torch.matmul`` (the JAX package leaves
them to XLA, outside any kernel).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

# stacked weight leaves that get int8 treatment (per family)
_QUANT_LEAVES = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                 "in_proj", "out_proj"}


def _quantize(w: torch.Tensor, red: Tuple[int, ...]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 of ``w`` with one scale per index of the axes not
    in ``red``.  |w| and its maximum are exact in ``w``'s own type, so
    only one float32 temporary of ``w``'s size is made (a full-width
    stacked leaf is gigabytes)."""
    amax = torch.amax(w.abs(), dim=red, keepdim=True).float()
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = w.to(torch.float32, copy=True).div_(scale).round_().clamp_(-127, 127)
    return q.to(torch.int8), scale


def quantize_tensor(w: torch.Tensor, axis: int = -1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 over ``axis`` (the output channels).

    Returns (q int8 same shape, scale f32 with ``axis`` kept)."""
    keep = axis % w.dim()
    return _quantize(w, tuple(i for i in range(w.dim()) if i != keep))


def _stacked_scale_axes(name: str, ndim: int) -> Tuple[int, ...]:
    """Reduction axes for a stacked [L, ..., d_out] weight: everything
    except the layer dim (0) and the output dim (-1)."""
    return tuple(range(1, ndim - 1))


def quantize_leaf(name: str, w: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(layer, output-channel) int8 for a stacked weight."""
    return _quantize(w, _stacked_scale_axes(name, w.dim()))


def quantize_params(params: Dict) -> Dict:
    """Quantize a model param tree for serving.

    Matmul weights → (name+"_q" int8, name+"_s" f32 broadcastable);
    norms / biases / small leaves stay as they are (the same tensors).
    """
    def walk(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in _QUANT_LEAVES and v.dim() >= 3:
                out[k + "_q"], out[k + "_s"] = quantize_leaf(k, v)
            elif k in ("embed", "lm_head"):
                out[k + "_q"], out[k + "_s"] = quantize_tensor(v, axis=-1)
            else:
                out[k] = v
        return out

    return walk(params)


def qmatmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
            ) -> torch.Tensor:
    """x @ dequant(q, s) computed as (x @ q)·s (exact for per-output-
    channel scales; no bf16 weight temporary of the scaled weight): the
    product on bf16 operands, the scale in f32, the result in x's
    type."""
    y = x.to(torch.bfloat16) @ q.to(torch.bfloat16)
    return (y.float() * torch.squeeze(s)).to(x.dtype)


class QLayerView:
    """Per-layer dict view over a quantized stacked-param tree that the
    layer functions (``attn_qkv``, ``mlp``, ``rms_norm``) can index with
    ``li = 0``: every leaf comes back as a ``[1, ...]`` slice, a
    quantized weight dequantized to bf16 (q and s each cast to bf16,
    then multiplied — the JAX package's order).  The full stack stays
    int8; a weight read twice in one layer is dequantized once."""

    def __init__(self, qtree: Dict, li: int):
        self.qtree = qtree
        self.li = li
        self._dequantized: Dict[str, torch.Tensor] = {}

    def __contains__(self, k):
        return k in self.qtree or (k + "_q") in self.qtree

    def __getitem__(self, k):
        t = self.qtree
        if k + "_q" not in t:
            return t[k][self.li:self.li + 1]
        w = self._dequantized.get(k)
        if w is None:
            q = t[k + "_q"][self.li].to(torch.bfloat16)
            s = t[k + "_s"][self.li].to(torch.bfloat16)
            w = self._dequantized[k] = (q * s)[None]
        return w


# ---------------------------------------------------------------------------
# int8 KV cache
# ---------------------------------------------------------------------------
def quantize_kv(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token's KV [B, KV, hd] → (int8, scale [B, KV])."""
    kf = k.float()
    scale = torch.clamp(kf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(kf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """[..., hd] int8 + [...] scale → f32."""
    return q.float() * scale[..., None]
