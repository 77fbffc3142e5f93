"""One module a model family, found by the ``reference`` key of a
configuration file's model entry (``families/<reference>.py``, beside
the plain reference ``reference/<reference>.py``).  A new family enters
the benchmark as new files: this module, its reference, a configuration
and a traffic file; nothing shared names a family.

A family module gives:

* ``leaves(m)``: ``(group, leaf, shape, kind, scale)`` of every leaf of
  model entry ``m``'s tree, in the order ``weights`` draws them;
* ``decode(m, parts)``, ``chunk(m, parts)``, ``prefill(m, parts)``: the
  bound of one step of each kind (a decode, a chunked prefill, a
  whole-prompt prefill) over ``parts``, one dict for each engine of model
  ``m`` in the step, holding that engine's real rows as the probe reads
  them from the step's arguments (``lens``; ``offs`` and ``clens``;
  ``rows``; ``fresh``).  Each returns ``(bytes, flops, kernels)``: the
  step's bytes and FLOPs, and for each kernel key the bound seconds of
  that kernel's calls, summed over the layers that call it.  A family
  that never takes a kind need not give it;
* ``KERNELS``: the kernel groups (key: a substring of the CUDA kernel's
  name) that the family's steps add to ``probe.KERNELS``;
* ``REDUCED``: the entry's sizes for the CPU rehearsal
  (``tests/cells.py``).
"""
from __future__ import annotations

import importlib
from pathlib import Path
from typing import Dict

HERE = Path(__file__).resolve().parent


def family(name: str):
    """The family module ``families/<name>.py``."""
    return importlib.import_module(f"muxbench.families.{name}")


def of(m: dict):
    """The family module of model entry ``m``."""
    return family(m["reference"])


def names():
    return sorted(p.stem for p in HERE.glob("*.py") if p.stem != "__init__")


def kernel_groups(base: Dict[str, str]) -> Dict[str, str]:
    """``base`` and the kernel groups of every family module; a key named
    twice must name the same kernels."""
    out = dict(base)
    for name in names():
        for key, pat in getattr(family(name), "KERNELS", {}).items():
            if out.setdefault(key, pat) != pat:
                raise ValueError(f"kernel group {key!r}: {out[key]!r} and "
                                 f"{pat!r} (family {name})")
    return out
