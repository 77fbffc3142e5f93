"""Input specs + sharding plans for every (arch × input-shape) pair
(port of ``repro/launch/specs.py``).

``build_lowering(arch, shape, mesh)`` returns everything
``launch/dryrun.py`` needs to run a step on a mesh: the step function,
abstract arguments (``meta`` tensors of the global shapes: no device
allocation, no generator draw) and the matching partition specs.

Conventions (the reference's):
  * audio/vlm shapes: ``tokens`` covers ``seq_len − n_prefix`` positions
    and the modality stub supplies ``prefix_emb`` for the rest, so the
    total context is exactly the assigned seq_len.
  * decode shapes carry a cache of ``seq_len`` context and process ONE
    token (lens = seq_len, new token at position seq_len−1).
  * long_500k runs the windowed/SSM decode path; pure full-attention
    archs without a windowed variant are skipped.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import configs
from repro_torch.config import SHAPES, ModelConfig, replace
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import tp_ways
from repro_torch.launch.sharding import P
from repro_torch.models.transformer import init_params
from repro_torch.train.optimizer import AdamWConfig, AdamWState, init_state
from repro_torch.train.train_step import make_train_step

BF16 = torch.bfloat16

# archs that run long_500k and the mechanism they use
LONG_CTX_MODE: Dict[str, str] = {
    "mamba2-2.7b": "ssm",
    "zamba2-1.2b": "hybrid-windowed",
    "musicgen-medium": "windowed",
    "qwen2-7b": "windowed",
}

SKIP_LONG = ("full-attention arch without a windowed variant at 500k "
             "context (DESIGN.md §4: long_500k requires sub-quadratic "
             "attention)")


@dataclass
class Lowering:
    arch: str
    shape: str
    kind: str                       # train | prefill | decode
    step_fn: Callable
    args: Tuple                     # meta tensors of the global shapes
    in_specs: Tuple                 # partition-spec trees (match args)
    donate: Tuple[int, ...] = ()
    cfg: Optional[ModelConfig] = None
    skip: Optional[str] = None      # reason, when not lowered


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def param_shapes(cfg: ModelConfig):
    """The parameter tree of ``cfg`` on ``meta`` (bf16 weights, the
    float32 leaves the reference keeps): shapes and dtypes only."""
    return init_params(cfg, None, dtype=BF16, device="meta")


def _n_attn_cache_layers(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def _prefix(cfg: ModelConfig, batch: int):
    if cfg.frontend_dim:
        return _sds((batch, cfg.n_prefix_tokens, cfg.frontend_dim),
                    torch.float32)
    return None


def _geometry(arch: str, shape_name: str, mesh, batch: Optional[int],
              n_layers: Optional[int]):
    shape = SHAPES[shape_name]
    logical = configs.get(arch)
    if n_layers is not None:
        logical = replace(logical, n_layers=n_layers)
    cfg = shd.physical_config(logical, tp_ways(mesh))
    B = shape.global_batch if batch is None else batch
    return shape, cfg, B, shape.seq_len


# ---------------------------------------------------------------------------
def build_quantized_decode(arch: str, shape_name: str, mesh,
                           batch: Optional[int] = None,
                           n_layers: Optional[int] = None) -> Lowering:
    """W8/KV8 decode with model-axis-only weight sharding
    (dense/moe/vlm/audio, full-cache decode shapes).  ``batch`` and
    ``n_layers`` as ``build_lowering``'s."""
    from repro_torch.serving.quantize import quantize_params
    shape, cfg, B, S = _geometry(arch, shape_name, mesh, batch, n_layers)
    tp = tp_ways(mesh)
    if shape.kind != "decode" or cfg.family not in (
            "dense", "moe", "vlm", "audio"):
        raise ValueError(f"{arch} × {shape_name}: the W8/KV8 variant "
                         f"takes the attention families' decode shapes")
    bspec = shd.batch_spec(mesh, B)
    b0 = bspec[0] if len(bspec) else None
    qshapes = quantize_params(param_shapes(cfg))
    # int8 weights usually fit model-sharded (no FSDP gathers); the
    # 235B MoE still needs the data dim even at int8
    fsdp = cfg.weight_bytes() / 2 / tp > 10 * 2 ** 30
    pspecs = shd.param_specs(qshapes, fsdp=fsdp)
    hd, KV, La = cfg.hd, cfg.n_kv_heads, cfg.n_layers
    step = steps.make_decode_step_w8kv8(cfg)
    kv_spec = P(None, b0, None, "model", None)
    sc_spec = P(None, b0, None, "model")
    args = (qshapes,
            _sds((La, B, S, KV, hd), torch.int8),
            _sds((La, B, S, KV, hd), torch.int8),
            _sds((La, B, S, KV), torch.float32),
            _sds((La, B, S, KV), torch.float32),
            _sds((B,), torch.int32), _sds((B,), torch.int32))
    ins = (pspecs, kv_spec, kv_spec, sc_spec, sc_spec, P(b0), P(b0))
    return Lowering(arch, shape_name, "decode", step, args, ins,
                    donate=(1, 2, 3, 4), cfg=cfg)


def build_lowering(arch: str, shape_name: str, mesh,
                   batch: Optional[int] = None,
                   n_layers: Optional[int] = None) -> Lowering:
    """The lowering of ``arch`` × ``shape_name`` on ``mesh``.  ``batch``
    cuts the shape's global batch (the card's check of the dry-run,
    ``chip_smoke.py``); ``n_layers`` sets the depth (the dry-run's depth
    extrapolation).  The FSDP and microbatch rules read the full
    model's size."""
    shape, cfg, B, S = _geometry(arch, shape_name, mesh, batch, n_layers)
    full = shd.physical_config(configs.get(arch), tp_ways(mesh))
    tp = tp_ways(mesh)
    bspec = shd.batch_spec(mesh, B)
    b0 = bspec[0] if len(bspec) else None
    # serving shapes drop the FSDP data-dim weight sharding when the
    # model-sharded weights fit comfortably: FSDP at inference means a
    # per-layer weight all-gather every step
    fsdp = shape.kind == "train" or \
        full.weight_bytes() / tp > 5 * 2 ** 30
    if shape.kind == "decode" and shape_name == "long_500k" \
            and arch not in LONG_CTX_MODE:
        return Lowering(arch, shape_name, "decode", None, (), (),
                        cfg=cfg, skip=SKIP_LONG)
    params = param_shapes(cfg)
    pspecs = shd.param_specs(params, fsdp=fsdp)

    # ---------------- train -------------------------------------------
    if shape.kind == "train":
        opt = AdamWConfig()
        # microbatch the giants so activations fit 16 GiB a device;
        # top-k=8 MoE gets a floor of 2 (slot expansion is 8× tokens)
        n_params = full.param_count()
        if n_params > 60e9:
            micro = 8
        elif n_params > 25e9 or (cfg.moe and cfg.moe.top_k >= 8):
            micro = 2
        else:
            micro = 1
        step = make_train_step(cfg, opt, remat=True, microbatches=micro)
        opt_state = init_state(params)
        ospecs = AdamWState(step=P(), m=pspecs, v=pspecs)
        n_pre = cfg.n_prefix_tokens if cfg.frontend_dim else 0
        s_tok = S - n_pre
        args = [params, opt_state,
                _sds((B, s_tok), torch.int32), _sds((B, s_tok), torch.int32)]
        ins = [pspecs, ospecs, P(b0, None), P(b0, None)]
        if cfg.frontend_dim:
            args.append(_prefix(cfg, B))
            ins.append(P(b0, None, None))
        return Lowering(arch, shape_name, "train", step, tuple(args),
                        tuple(ins), donate=(0, 1), cfg=cfg)

    # ---------------- prefill -----------------------------------------
    if shape.kind == "prefill":
        step = steps.make_prefill_step(cfg)
        n_pre = cfg.n_prefix_tokens if cfg.frontend_dim else 0
        s_tok = S - n_pre
        args = [params, _sds((B, s_tok), torch.int32),
                _sds((B,), torch.int32)]
        ins = [pspecs, P(b0, None), P(b0)]
        if cfg.frontend_dim:
            args.append(_prefix(cfg, B))
            ins.append(P(b0, None, None))
        return Lowering(arch, shape_name, "prefill", step, tuple(args),
                        tuple(ins), cfg=cfg)

    # ---------------- decode ------------------------------------------
    windowed = shape_name == "long_500k" and \
        LONG_CTX_MODE.get(arch, "").endswith("windowed")
    fam = cfg.family
    hd, KV = cfg.hd, cfg.n_kv_heads
    La = _n_attn_cache_layers(cfg)
    kv_spec = P(None, b0, None, "model", None)
    w_spec = P(None, b0, "model", None, None)
    i32 = torch.int32

    if fam in ("dense", "moe", "vlm", "audio"):
        step = steps.make_decode_step(cfg, windowed=windowed)
        if windowed:
            W = cfg.sliding_window
            caches = [_sds((La, B, KV, W, hd), BF16),
                      _sds((La, B, KV, W, hd), BF16)]
            cspecs = [w_spec, w_spec]
        else:
            caches = [_sds((La, B, S, KV, hd), BF16),
                      _sds((La, B, S, KV, hd), BF16)]
            cspecs = [kv_spec, kv_spec]
        args = [params, *caches, _sds((B,), i32), _sds((B,), i32)]
        ins = [pspecs, *cspecs, P(b0), P(b0)]
        return Lowering(arch, shape_name, "decode", step, tuple(args),
                        tuple(ins), donate=(1, 2), cfg=cfg)

    sc = cfg.ssm
    conv_dim = cfg.d_inner + 2 * sc.n_groups * sc.d_state
    st = _sds((cfg.n_layers, B, cfg.n_ssm_heads, sc.head_dim, sc.d_state),
              torch.float32)
    tail = _sds((cfg.n_layers, B, sc.conv_kernel - 1, conv_dim), BF16)

    if fam == "ssm":
        step = steps.make_decode_step(cfg)
        args = [params, st, tail, _sds((B,), i32), _sds((B,), i32)]
        ins = [pspecs, shd.ssm_state_spec(mesh, B),
               shd.conv_tail_spec(mesh, B), P(b0), P(b0)]
        return Lowering(arch, shape_name, "decode", step, tuple(args),
                        tuple(ins), donate=(1, 2), cfg=cfg)

    if fam == "hybrid":
        step = steps.make_decode_step(cfg, windowed=windowed)
        if windowed:
            W = cfg.sliding_window
            ck = (La, B, KV, W, hd)
            cspec = w_spec
        else:
            ck = (La, B, S, KV, hd)
            cspec = kv_spec
        args = [params, st, tail, _sds(ck, BF16), _sds(ck, BF16),
                _sds((B,), i32), _sds((B,), i32)]
        ins = [pspecs, shd.ssm_state_spec(mesh, B),
               shd.conv_tail_spec(mesh, B), cspec, cspec, P(b0), P(b0)]
        return Lowering(arch, shape_name, "decode", step, tuple(args),
                        tuple(ins), donate=(1, 2, 3, 4), cfg=cfg)

    raise ValueError(fam)


def all_pairs():
    for arch in configs.ARCH_IDS:
        dashed = {v: k for k, v in configs.ALIASES.items()}[arch]
        for shape in SHAPES:
            yield dashed, shape
