"""The port imports neither JAX nor the JAX package ``roko_tpu``.

Every module of ``roko_tpu_torch`` is imported in a subprocess in which
``jax`` and ``roko_tpu`` (with all its submodules) are blocked, and the
import statements of the package and of ``chip_smoke.py`` are read with
``ast``. A name counts as the JAX package when it is ``roko_tpu`` or
starts with ``roko_tpu.``; ``roko_tpu_torch`` is not it."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "roko_tpu_torch"

_CHILD = r"""
import pkgutil, sys
from pathlib import Path

root = Path(sys.argv[1])
blocked = ["jax", "jaxlib", "roko_tpu"]
for path in (root / "roko_tpu").rglob("*.py"):
    parts = path.relative_to(root).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    blocked.append(".".join(parts))
for name in blocked:
    sys.modules[name] = None  # import of a None entry raises ImportError

sys.path.insert(0, str(root))
import roko_tpu_torch

names = ["roko_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(roko_tpu_torch.__path__, "roko_tpu_torch.")
]
for name in names:
    __import__(name)
print(" ".join(names))
"""


def _is_jax_side(name: str) -> bool:
    return any(name == top or name.startswith(top + ".") for top in ("jax", "jaxlib", "roko_tpu"))


@pytest.mark.parametrize(
    "name,expected",
    [("roko_tpu", True), ("roko_tpu.infer", True), ("jax.numpy", True),
     ("roko_tpu_torch", False), ("roko_tpu_torch.infer", False), ("jaxtyping", False)],
)
def test_jax_side_name_rule(name, expected):
    assert _is_jax_side(name) is expected


def test_every_port_module_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(ROOT)],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT), env=env,
    )
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.strip().splitlines()[-1].split()
    assert len(names) >= 16
    assert {"roko_tpu_torch.models.fused_lingru", "roko_tpu_torch.models.lingru"} <= set(names)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path", [ROOT / "chip_smoke.py", *sorted(PORT.rglob("*.py"))],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_import_statements(path):
    bad = [name for name in _imports(path) if _is_jax_side(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
