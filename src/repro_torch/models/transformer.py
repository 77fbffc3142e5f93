"""Parameter trees of every family (port of the init half of
``repro/models/transformer.py``) and the bridge that carries the JAX
package's weights across.

Trees have the JAX package's shapes and keys leaf for leaf, per-layer
leaves stacked ``[L, ...]`` and matrices ``[d_in, d_out]``:

  dense  ``{"tok": {embed, out_norm, [lm_head]}, "layers": {wq, wk, wv,
         wo, [bq, bk, bv], [q_norm, k_norm], w_gate, w_up, w_down, ln1,
         ln2}}`` (also vlm and audio, whose frontends are stubs)
  moe    the dense tree with the MLP replaced by ``models/moe.init_moe``'s
         ``router`` [L, d, E] (float32) and experts ``w_gate``, ``w_up``
         [L, E, d, f_e], ``w_down`` [L, E, f_e, d]
  ssm    ``{"tok", "layers": {<mamba2 leaves>, ln1}}``
  hybrid the ssm tree plus ``"shared_attn"``: one attention + MLP block
         (Zamba2-style tied weights) with its own ``ln1``/``ln2``, every
         leaf ``[1, ...]``.
``forward`` is the training / prefill forward of every family (port of
``repro/models/transformer.py``'s ``forward``): a Python loop over the
stacked ``[L, ...]`` leaves in place of ``jax.lax.scan``, attention
through ``kernels/flash_prefill.flash_prefill`` (kernel 3 on CUDA) and
the SSD scan through ``models/mamba2.ssd_chunked`` (kernel 4 on CUDA),
both differentiable.  On ``meta`` tensors (the dry-run) attention is
``layers.blocked_causal_attention``, as the reference's forward always
runs it; on a mesh the residual stream is constrained between layers
(``layers.shard_activation``) and the SSM layers run sequence-parallel
over the model axis.  ``remat`` checkpoints each layer (each group of
``attn_every`` Mamba2 layers and the shared block, for the hybrid) with
``torch.utils.checkpoint``, as the JAX package's ``jax.checkpoint``.
``loss_fn`` is the causal LM cross-entropy over the PADDED vocabulary,
as the reference's.  The serving engine runs its own forward
(``serving/engine.py``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.config import ModelConfig, pad_vocab
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.models import moe as MoE
from repro_torch.models.layers import (attention_on_shards, attn_qkv,
                                       blocked_causal_attention,
                                       current_mesh, distributed, init_attn,
                                       init_embed, init_mlp, linear,
                                       lm_logits, mlp, model_axis_size,
                                       rms_norm, shard_activation)
from repro_torch.models.mamba2 import (FLOAT32_LEAVES, init_mamba2,
                                       mamba2_mixer)

Params = Dict

# leaves the JAX package keeps in float32 whatever the tree's dtype
_F32_LEAVES = set(FLOAT32_LEAVES) | {"router"}


def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype=torch.bfloat16, device="cuda") -> Params:
    """Random weights for a model of any family, drawn from ``gen`` (its
    device must be ``device``).  Same tree shapes as the JAX package's
    ``init_params``; the numbers differ (another generator)."""
    if cfg.family not in ("dense", "vlm", "audio", "moe", "ssm", "hybrid"):
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
    device = resolve_device(device)
    v_pad = pad_vocab(cfg.vocab_size)
    L, d = cfg.n_layers, cfg.d_model

    def ones(n):
        return torch.ones((n, d), dtype=dtype, device=device)
    p: Params = {"tok": init_embed(cfg, v_pad, gen, dtype, device)}
    if cfg.family in ("ssm", "hybrid"):
        p["layers"] = {**init_mamba2(cfg, L, gen, dtype, device),
                       "ln1": ones(L)}
        if cfg.family == "hybrid":
            p["shared_attn"] = {
                **init_attn(cfg, 1, gen, dtype, device),
                **init_mlp(d, cfg.d_ff, 1, gen, dtype, device),
                "ln1": ones(1), "ln2": ones(1)}
        return p
    # attention first, then the FFN: the generator's draws in tree order
    layers = init_attn(cfg, L, gen, dtype, device)
    layers.update(MoE.init_moe(cfg, L, gen, dtype, device)
                  if cfg.family == "moe"
                  else init_mlp(d, cfg.d_ff, L, gen, dtype, device))
    p["layers"] = {**layers, "ln1": ones(L), "ln2": ones(L)}
    return p


def params_to_torch(tree, device="cuda", dtype=torch.float32,
                    _key: str = "") -> Params:
    """Turn a parameter tree of numpy arrays (the JAX package's tree
    mapped through ``np.asarray``) into the port's tree: same nesting,
    same layout — ``[L, d_in, d_out]`` applied as ``x @ w``, a leading
    ``[M, ...]`` axis where stacked — no transposes.  Leaves go to
    ``dtype``, except the leaves the JAX package keeps in float32 (the
    Mamba2 ``FLOAT32_LEAVES`` and the MoE ``router``), which stay
    float32, and the leaves of
    a quantized tree (``serving.quantize.quantize_params``): int8
    values ``*_q`` stay int8 and their scales ``*_s`` float32."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_to_torch(v, device, dtype, k)
                for k, v in tree.items()}
    if _key.endswith("_q"):
        return torch.from_numpy(np.array(tree, np.int8)).to(device)
    to = torch.float32 if (_key in _F32_LEAVES
                           or _key.endswith("_s")) else dtype
    return torch.from_numpy(np.array(tree, np.float32)).to(
        device=device, dtype=to)


# ---------------------------------------------------------------------------
# forward (train / prefill semantics: full sequence, causal)
# ---------------------------------------------------------------------------
def _attn_block(x, lp, li, cfg: ModelConfig, positions, window):
    h = rms_norm(x, lp["ln1"][li], cfg.rms_eps)
    q, k, v = attn_qkv(h, lp, li, cfg, positions)
    if q.device.type == "meta":
        o = blocked_causal_attention(q, k, v, window=window)
    else:
        o = attention_on_shards(
            lambda *a: flash_prefill(*a, window=window), q, k, v)
    b, s, _, _ = o.shape
    return x + linear(o.reshape(b, s, -1), lp["wo"][li])


def _mlp_block(x, lp, li, cfg: ModelConfig):
    h = rms_norm(x, lp["ln2"][li], cfg.rms_eps)
    return x + mlp(h, lp, li)


def _moe_block(x, lp, li, cfg: ModelConfig, dropless: bool = False):
    h = rms_norm(x, lp["ln2"][li], cfg.rms_eps)
    fn = MoE.moe_ffn_dropless if dropless else MoE.moe_ffn
    out, aux = fn(h, lp, li, cfg)
    return x + out, aux


def _ssm_layer(x, lp, li, cfg: ModelConfig, sp: int = 0):
    h = rms_norm(x, lp["ln1"][li], cfg.rms_eps)
    out, _ = mamba2_mixer(h, lp, li, cfg, seq_parallel=sp)
    return shard_activation(x + out, seq="model")


def embed_inputs(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 prefix_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = params["tok"]["embed"][tokens]                   # [B,S,d]
    if prefix_emb is not None:
        x = torch.cat([prefix_emb.to(x.dtype), x], dim=1)
    return x


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            prefix_emb: Optional[torch.Tensor] = None,
            window: Optional[int] = None,
            remat: bool = True,
            moe_dropless: bool = False,
            slice_vocab: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full causal forward.  Returns (logits [B, S_total, vocab],
    aux_loss, a float32 scalar: the MoE layers' load-balance loss summed,
    0 for the other families).

    ``window`` optionally restricts attention (sliding-window variant);
    ``moe_dropless`` picks the dropless MoE FFN, else the capacity FFN;
    ``slice_vocab=False`` keeps the padded vocabulary's columns."""
    x = shard_activation(embed_inputs(params, cfg, tokens, prefix_emb))
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    lp = params["layers"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(fn, *args):
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    if cfg.family in ("dense", "vlm", "audio", "moe"):
        def layer(x, li):
            x = _attn_block(x, lp, li, cfg, positions, window)
            if cfg.family == "moe":
                x, a = _moe_block(x, lp, li, cfg, moe_dropless)
            else:
                x, a = _mlp_block(x, lp, li, cfg), None
            return shard_activation(x, seq="model"), a

        for li in range(cfg.n_layers):
            x, a = run(layer, x, li)
            if a is not None:
                aux = aux + a

    elif cfg.family == "ssm":
        sp = model_axis_size()        # sequence-parallel SSD on a mesh
        for li in range(cfg.n_layers):
            x = run(_ssm_layer, x, lp, li, cfg, sp)

    elif cfg.family == "hybrid":
        # [attn_every x mamba2 -> shared attn + MLP] x n_groups, then the
        # ungrouped tail layers
        sa = params["shared_attn"]
        n_groups = cfg.n_layers // cfg.attn_every
        sp = model_axis_size()        # sequence-parallel SSD on a mesh

        def group(x, gi):
            for j in range(cfg.attn_every):
                x = _ssm_layer(x, lp, gi * cfg.attn_every + j, cfg, sp)
            x = _attn_block(x, sa, 0, cfg, positions, window)
            x = _mlp_block(x, sa, 0, cfg)
            return shard_activation(x, seq="model")

        for gi in range(n_groups):
            x = run(group, x, gi)
        for li in range(n_groups * cfg.attn_every, cfg.n_layers):
            x = _ssm_layer(x, lp, li, cfg, sp)
    else:
        raise ValueError(cfg.family)

    logits = lm_logits(x, params["tok"], cfg)
    if slice_vocab:
        logits = logits[..., :cfg.vocab_size]
    return logits, aux


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy over the labels >= 0 (−100 masks), in
    float32, as the reference computes it: the max is taken out without
    a gradient, the log-sum-exp runs over every column of ``logits``
    (on a mesh the vocab dim rides the model axis)."""
    logits = shard_activation(logits, last="model")
    mask = labels >= 0
    safe = labels.clamp(min=0).long()
    lmax = logits.max(dim=-1, keepdim=True).values.detach()
    shifted = (logits - lmax).float()
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    if current_mesh() is None:
        picked = torch.gather(shifted, -1, safe[..., None])[..., 0]
    else:
        # the label's logit by an iota compare, as the reference picks
        # it: a gather along the sharded vocab dim has no DTensor rule;
        # the iota is sharded as the vocab dim is
        vocab = distributed(torch.arange(shifted.shape[-1],
                                         device=shifted.device), "model")
        picked = torch.where(vocab == safe[..., None], shifted,
                             0.0).sum(dim=-1)
    nll = lse - picked
    n = mask.sum().clamp(min=1)
    return (nll * mask).sum() / n


def loss_fn(params: Params, cfg: ModelConfig, tokens, labels,
            prefix_emb=None, remat: bool = True) -> torch.Tensor:
    """Causal LM cross-entropy (labels −100 are masked) plus the MoE
    aux loss.  The logits keep the padded vocabulary (``slice_vocab=
    False``), as the reference's: labels never index the padding, but
    its columns enter the log-sum-exp."""
    logits, aux = forward(params, cfg, tokens, prefix_emb, remat=remat,
                          slice_vocab=False)
    if prefix_emb is not None:
        logits = logits[:, prefix_emb.shape[1]:]
    return cross_entropy(logits, labels) + aux
