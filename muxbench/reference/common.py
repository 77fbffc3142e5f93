"""What the references share: float32 without TF32, the RMS norm, the
control's weight quantisation, and the logit gaps that are compared."""
from __future__ import annotations

import importlib
from typing import Dict, List, Sequence, Tuple

import torch

FP8_MAX = 448.0          # largest finite float8_e4m3fn


def exact_float32() -> None:
    """Float32 matmuls in float32: on the H100 TF32 is a lower precision
    that PyTorch may pick for them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def fp8_weight(w: torch.Tensor) -> torch.Tensor:
    """``w`` ``[d_in, d_out]`` through float8 e4m3 with one scale an
    output channel, back in float32: the weight-only fp8 step below the
    configuration's bfloat16 (the control)."""
    w = w.float()
    s = w.abs().amax(dim=0, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (w / s).to(torch.float8_e4m3fn).float() * s


def matrix(t: torch.Tensor, control: bool) -> torch.Tensor:
    return fp8_weight(t) if control else t.float()


def family(name: str):
    return importlib.import_module(f"muxbench.reference.{name}")


def served_gaps(m: dict, tree: Dict[str, Dict[str, torch.Tensor]],
                seqs: Sequence[Tuple[List[int], List[int]]],
                control: bool = False, block: int = 256) -> dict:
    """The logit gaps of the tokens a program served, under the float32
    reference of model entry ``m`` with weights ``tree``.

    ``seqs``: (prompt, served tokens) pairs.  At each served position
    the gap is the reference's best logit minus its logit of the served
    token (0 where the program served the reference's argmax).  Returns
    ``program``, the widest gap of each sequence, and with ``control``
    also ``control``: the widest gap, under the same float32 logits, of
    the tokens the reference computed with weight-only fp8 puts first
    at the same positions of the same sequences."""
    exact_float32()
    ref = family(m["reference"])
    toks = [torch.tensor(p + s[:-1], dtype=torch.long,
                         device=tree["tok"]["embed"].device)
            for p, s in seqs]
    h_ref = ref.final_hidden(m, tree, toks, control=False)
    h_ctl = ref.final_hidden(m, tree, toks, control=True) if control \
        else None
    out_ref = ref.output_matrix(m, tree, control=False)
    out_ctl = ref.output_matrix(m, tree, control=True) if control else None
    V = m["vocab_size"]
    res: Dict[str, list] = {"program": [], "control": []}
    for i, (p, s) in enumerate(seqs):
        pos0 = len(p) - 1
        served = torch.tensor(s, dtype=torch.long, device=out_ref.device)
        g_prog, g_ctl = 0.0, 0.0
        for a in range(0, len(s), block):
            rows = slice(pos0 + a, pos0 + min(a + block, len(s)))
            lg = (h_ref[i][rows] @ out_ref)[:, :V]
            best = lg.max(dim=-1).values
            tok = served[a:a + block]
            mine = lg.gather(1, tok[:, None])[:, 0]
            g_prog = max(g_prog, float((best - mine).max()))
            if control:
                lc = (h_ctl[i][rows] @ out_ctl)[:, :V]
                pick = lc.argmax(dim=-1)
                theirs = lg.gather(1, pick[:, None])[:, 0]
                g_ctl = max(g_ctl, float((best - theirs).max()))
        res["program"].append(g_prog)
        if control:
            res["control"].append(g_ctl)
    if not control:
        del res["control"]
    return res

