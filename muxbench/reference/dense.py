"""Plain float32 reference of a dense GQA decoder (Qwen2): pre-norm
blocks of RMS norm, attention with QKV bias and rotary positions (the
half-split form, theta from the configuration), SwiGLU MLP; a final RMS
norm and an untied output matrix."""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from muxbench.reference.common import matrix, rms_norm


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, heads, hd] at positions 0..T-1."""
    T, _, hd = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def layer(x: torch.Tensor, w: Dict[str, torch.Tensor], m: dict
          ) -> torch.Tensor:
    T = x.shape[0]
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    eps = m["rms_eps"]
    h = rms_norm(x, w["ln1"], eps)
    q, k, v = h @ w["wq"], h @ w["wk"], h @ w["wv"]
    if "bq" in w:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = rope(q.view(T, H, hd), m["rope_theta"])
    k = rope(k.view(T, KV, hd), m["rope_theta"]).repeat_interleave(
        H // KV, dim=1)
    v = v.view(T, KV, hd).repeat_interleave(H // KV, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("hqk,khd->qhd", p, v).reshape(T, H * hd)
    x = x + o @ w["wo"]
    h = rms_norm(x, w["ln2"], eps)
    return x + (F.silu(h @ w["w_gate"]) * (h @ w["w_up"])) @ w["w_down"]


MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def final_hidden(m: dict, tree, toks: List[torch.Tensor], control: bool
                 ) -> List[torch.Tensor]:
    """Each sequence's hidden states after the final norm, [T, d]."""
    lay = tree["layers"]
    xs = [tree["tok"]["embed"][t].float() for t in toks]
    for li in range(m["n_layers"]):
        w = {k: (matrix(v[li], control) if k in MATRICES else v[li].float())
             for k, v in lay.items()}
        xs = [layer(x, w, m) for x in xs]
        del w
    norm = tree["tok"]["out_norm"].float()
    return [rms_norm(x, norm, m["rms_eps"]) for x in xs]


def output_matrix(m: dict, tree, control: bool) -> torch.Tensor:
    return matrix(tree["tok"]["lm_head"], control)
