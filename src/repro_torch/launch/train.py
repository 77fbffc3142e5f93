"""Training driver (port of ``repro/launch/train.py``): reduced configs
on the CPU, full configs on the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \
      --steps 200 --batch 8 --seq 64 --ckpt /tmp/ckpt --device cpu

The JAX CLI's flags and log lines, plus ``--device`` (default
``cuda``; it raises where there is no GPU, as ``launch/serve.py``).
Parameters are float32, drawn from a ``torch.Generator`` seeded with
``--seed`` (other numbers than the JAX CLI's ``PRNGKey``), and TF32 is
off, so a float32 product on the card runs in float32.  The step is
``compile_train_step(make_train_step(...))``, as the reference jits it:
on the card one CUDA graph, captured at the first step (on the restored
tensors after a resume) and replayed at every later one; on the CPU,
or inside ``serving.graphs.disable_graphs()``, the eager step.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.data import DataConfig, synth_batch
from repro_torch.train.graphs import compile_train_step
from repro_torch.train.optimizer import AdamWConfig, init_state
from repro_torch.train.pytree import leaves
from repro_torch.train.train_step import make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--full", action="store_true",
                    help="use the full config (needs the card)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get(args.arch) if args.full\
        else configs.get_reduced(args.arch)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                      total_steps=args.steps)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, torch.float32, device)
    state = init_state(params)
    start = 0
    if args.ckpt and ckpt_lib.latest_step(args.ckpt) is not None:
        tree, start, _ = ckpt_lib.restore(args.ckpt,
                                          {"p": params, "o": state})
        params, state = tree["p"], tree["o"]
        print(f"[train] resumed from step {start}")

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed,
                      frontend_dim=cfg.frontend_dim,
                      n_prefix_tokens=cfg.n_prefix_tokens)
    step_fn = compile_train_step(make_train_step(
        cfg, opt, remat=False, microbatches=args.microbatches))

    n_params = sum(int(np.prod(p.shape)) for p in leaves(params))
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch} × seq {args.seq}")
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        # host tensors: the compiled step copies them to the card
        toks, labels, prefix = synth_batch(dcfg, i)
        a = [params, state, torch.from_numpy(toks).long(),
             torch.from_numpy(labels)]
        if prefix is not None:
            a.append(torch.from_numpy(prefix))
        params, state, m = step_fn(*a)
        if (i + 1) % args.log_every == 0 or i == start:
            tps = args.batch * args.seq * (i + 1 - start)\
                / (time.perf_counter() - t0)
            print(f"[train] step {i + 1:5d}  loss={float(m['loss']):.4f}  "
                  f"lr={float(m['lr']):.2e}  "
                  f"gnorm={float(m['grad_norm']):.2f}  tok/s={tps:.0f}")
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            path = ckpt_lib.save(args.ckpt, {"p": params, "o": state},
                                 step=i + 1)
            print(f"[train] checkpoint → {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
