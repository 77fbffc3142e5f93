"""Plain float32 reference of Mamba2 (arXiv:2405.21060): pre-norm blocks
of the SSD mixer — input projection to (z, x, B, C, dt), a depthwise
causal convolution with SiLU over (x, B, C), the selective state space
h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t + D x_t computed
chunk-wise as the paper's minimal SSD listing, the gated RMS norm
norm(y * silu(z)) and the output projection — then a final RMS norm and
the output tied to the embedding."""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from muxbench.reference.common import matrix, rms_norm

CHUNK = 64


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x [..., T] -> [..., T, T]: sum of x over (j, i] below the
    diagonal, 0 on it, -inf above."""
    T = x.shape[-1]
    xx = x[..., None].expand(*x.shape, T)
    low = torch.ones(T, T, dtype=torch.bool, device=x.device).tril(-1)
    cs = torch.cumsum(xx.masked_fill(~low, 0.0), dim=-2)
    keep = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    return cs.masked_fill(~keep, float("-inf"))


def ssd(X: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
        chunk: int = CHUNK) -> torch.Tensor:
    """The paper's minimal discrete SSD, one sequence from a zero state.
    X [T, H, P] (x already times dt), A [T, H] (A times dt), B, C
    [T, H, N].  Returns y [T, H, P] without the D skip."""
    T = X.shape[0]
    pad = -T % chunk
    if pad:
        X, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (X, B, C))
        A = F.pad(A, (0, 0, 0, pad))
    c = X.shape[0] // chunk
    X = X.view(c, chunk, *X.shape[1:])
    B = B.view(c, chunk, *B.shape[1:])
    C = C.view(c, chunk, *C.shape[1:])
    A = A.view(c, chunk, -1).permute(2, 0, 1)                # [H, c, l]
    A_cum = torch.cumsum(A, dim=-1)
    Lmat = torch.exp(segsum(A))                              # [H, c, l, l]
    y_diag = torch.einsum("clhn,cshn,hcls,cshp->clhp", C, B, Lmat, X)
    decay = torch.exp(A_cum[..., -1:] - A_cum)               # [H, c, l]
    states = torch.einsum("clhn,hcl,clhp->chpn", B, decay, X)
    states = torch.cat([torch.zeros_like(states[:1]), states], dim=0)
    chunk_decay = torch.exp(segsum(F.pad(A_cum[..., -1], (1, 0))))
    states = torch.einsum("hzc,chpn->zhpn", chunk_decay, states)[:-1]
    y_off = torch.einsum("clhn,chpn,hcl->clhp", C, states, torch.exp(A_cum))
    return (y_diag + y_off).reshape(c * chunk, *y_diag.shape[2:])[:T]


def layer(x: torch.Tensor, w: Dict[str, torch.Tensor], m: dict
          ) -> torch.Tensor:
    s = m["ssm"]
    T, d = x.shape
    di = s["expand"] * d
    P, N, G, K = s["head_dim"], s["d_state"], s["n_groups"], \
        s["conv_kernel"]
    H = di // P
    eps = m["rms_eps"]
    h = rms_norm(x, w["ln1"], eps)
    z, xs, B, C, dt = torch.split(h @ w["in_proj"],
                                  [di, di, G * N, G * N, H], dim=-1)
    xbc = torch.cat([xs, B, C], dim=-1)                      # [T, conv]
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(xp[i:i + T] * w["conv_w"][i] for i in range(K))
    xbc = F.silu(conv + w["conv_b"])
    xs, B, C = torch.split(xbc, [di, G * N, G * N], dim=-1)
    dt = F.softplus(dt + w["dt_bias"])                       # [T, H]
    A = -torch.exp(w["a_log"])                               # [H]
    xh = xs.view(T, H, P)
    Bh = B.view(T, G, N).repeat_interleave(H // G, dim=1)
    Ch = C.view(T, G, N).repeat_interleave(H // G, dim=1)
    y = ssd(xh * dt[..., None], A * dt, Bh, Ch) + w["d_skip"][:, None] * xh
    y = rms_norm(y.reshape(T, di) * F.silu(z), w["gnorm"], eps)
    return x + y @ w["out_proj"]


MATRICES = ("in_proj", "out_proj")


def final_hidden(m: dict, tree, toks: List[torch.Tensor], control: bool
                 ) -> List[torch.Tensor]:
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
    return matrix(tree["tok"]["embed"].t(), control)
