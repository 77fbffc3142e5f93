"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program.  Compared by whole top-level
names: the port's name begins with the JAX package's."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ALL = ("jax", "jaxlib", "flax", "repro")
REFERENCE = ALL + ("repro_torch",)


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


MODULES = sorted(p for p in HERE.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(HERE)) for p in MODULES])
def test_module_imports(path):
    banned = REFERENCE if "reference" in path.relative_to(HERE).parts \
        else ALL
    found = set(top_level_imports(path)) & set(banned)
    assert not found, f"{path} imports {sorted(found)}"


def test_the_check_compares_whole_names():
    src = "import repro_torch.serving\nfrom repro.x import y\n"
    p = HERE / "tests" / "_names_probe.py"
    p.write_text(src)
    try:
        names = set(top_level_imports(p))
    finally:
        p.unlink()
    assert names == {"repro_torch", "repro"}


def test_loaded_reference_holds_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r);"
            "import muxbench.reference.common, muxbench.reference.dense,"
            "muxbench.reference.mamba2, muxbench.weights;"
            "print(sorted({k.split('.')[0] for k in sys.modules}))"
            % str(HERE.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    held = set(eval(out))
    assert not held & set(REFERENCE)


def test_a_run_process_holds_no_jax():
    from muxbench import harness
    harness.port()
    import muxbench.run  # noqa: F401
    assert harness.forbidden_modules() == []
