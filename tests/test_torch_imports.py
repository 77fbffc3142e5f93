"""Ground rules of the port that no runtime test can see.

* The port (``src/repro_torch``) and ``chip_smoke.py`` import neither
  ``jax`` nor anything of the JAX package ``repro`` — not even modules
  of it that import no JAX: the port keeps its own copies.
* Entry points run on the GPU unless asked for the CPU, and raise a
  clear error where there is none.
"""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.lineno, node.module


def test_port_imports_neither_jax_nor_the_reference():
    assert len(FILES) > 20
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in FILES for line, mod in _imports(p)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_import_guard_catches_a_reference_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import os\nfrom repro.serving import mux\n"
                     "import jax.numpy as jnp\nfrom repro_torch import x\n")
    assert [m for _, m in _imports(probe)
            if m.split(".")[0] in FORBIDDEN] == ["repro.serving", "jax.numpy"]


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from repro_torch.launch import serve
    from repro_torch.serving.driver import build_unit_from_specs
    from repro_torch.serving.kvcache import UnifiedKVPool
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_unit_from_specs([("a", "qwen2-7b", 1.0)], pool_blocks=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UnifiedKVPool(16, 64)
    with pytest.raises(SystemExit):
        serve.main(["--horizon", "1"])
    # the same entry point runs when asked for the CPU
    unit = build_unit_from_specs([("a", "qwen2-7b", 1.0)], pool_blocks=64,
                                 dtype=torch.float32, device="cpu")
    assert unit.pool.k.device.type == "cpu"
