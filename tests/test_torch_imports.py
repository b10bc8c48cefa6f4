"""The port imports neither JAX nor the JAX package ``roko_tpu``, and its
host-side modules (features, I/O, the native extractor, the simulator,
the assess tool, failure handling, the batching plane's scheduler, the
training data plane) do not import torch.

Every module of ``roko_tpu_torch`` is imported in a subprocess in which
``jax`` and ``roko_tpu`` (with all its submodules) are blocked, the
host-side modules once more with ``torch`` blocked too, and the import
statements of the package and of ``chip_smoke.py`` are read with
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
only = sys.argv[2:]  # with names given: import those, and block torch too
blocked = ["jax", "jaxlib", "roko_tpu"] + (["torch"] if only else [])
for path in (root / "roko_tpu").rglob("*.py"):
    parts = path.relative_to(root).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    blocked.append(".".join(parts))
for name in blocked:
    sys.modules[name] = None  # import of a None entry raises ImportError

sys.path.insert(0, str(root))
import roko_tpu_torch

names = only or ["roko_tpu_torch"] + [
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


def _import_in_child(*names):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(ROOT), *names],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT), env=env,
    )
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()[-1].split()


#: the host side of the port: feature extraction runs in worker
#: processes and threads, and the assess tool, the failure handling,
#: the batching plane's scheduler and the training data plane are host
#: code, so none of it may import torch
HOST_MODULES = [
    "roko_tpu_torch.sim", "roko_tpu_torch.utils.rng", "roko_tpu_torch.resilience.retry",
    "roko_tpu_torch.io.bgzf", "roko_tpu_torch.io.bam", "roko_tpu_torch.io.sam",
    "roko_tpu_torch.io.fasta", "roko_tpu_torch.native.build", "roko_tpu_torch.native.binding",
    "roko_tpu_torch.features.pileup", "roko_tpu_torch.features.extract",
    "roko_tpu_torch.features.labels", "roko_tpu_torch.features.backend",
    "roko_tpu_torch.features.pipeline", "roko_tpu_torch.data.hdf5",
    "roko_tpu_torch.eval", "roko_tpu_torch.eval.align", "roko_tpu_torch.eval.assess",
    "roko_tpu_torch.utils.profiling", "roko_tpu_torch.obs.events",
    "roko_tpu_torch.resilience",
    "roko_tpu_torch.resilience.watchdog", "roko_tpu_torch.resilience.journal",
    "roko_tpu_torch.serve.batcher", "roko_tpu_torch.serve.metrics",
    "roko_tpu_torch.serve.scheduler", "roko_tpu_torch.datapipe",
    "roko_tpu_torch.datapipe.io", "roko_tpu_torch.datapipe.manifest",
    "roko_tpu_torch.datapipe.engine", "roko_tpu_torch.datapipe.dataset",
    "roko_tpu_torch.training.data", "roko_tpu_torch.training.lazy_data",
]


def test_every_port_module_imports_without_jax():
    names = _import_in_child()
    assert len(names) >= 70
    assert "roko_tpu_torch.training.engine" not in names  # moved to datapipe.engine
    assert {"roko_tpu_torch.models.fused_lingru", "roko_tpu_torch.models.lingru",
            "roko_tpu_torch.models.transformer",
            "roko_tpu_torch.models.quant", "roko_tpu_torch.benchmark",
            "roko_tpu_torch.serve.session", "roko_tpu_torch.pipeline.stream",
            "roko_tpu_torch.datapipe", "roko_tpu_torch.datapipe.io",
            "roko_tpu_torch.datapipe.manifest", "roko_tpu_torch.datapipe.engine",
            "roko_tpu_torch.datapipe.dataset", "roko_tpu_torch.training.lazy_data",
            "roko_tpu_torch.parallel", "roko_tpu_torch.parallel.distributed",
            "roko_tpu_torch.parallel.mesh", "roko_tpu_torch.parallel.tp",
            "roko_tpu_torch.parallel.ring", *HOST_MODULES} <= set(names)


def test_host_modules_import_without_torch():
    assert _import_in_child(*HOST_MODULES) == HOST_MODULES


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


def test_every_kernel_has_its_source_dtype_and_counter():
    """The eight kernels of ``kernels.KERNELS``, each with its source in
    ``csrc/`` and its dtype, and every wrapper's launch counters (a bf16
    kernel counts on ``launches_bf16`` beside its f32 sibling's
    ``launches``)."""
    import torch

    from roko_tpu_torch import kernels
    from roko_tpu_torch.models import fused_gru as fg
    from roko_tpu_torch.models import fused_lingru as fl

    names = {f"{k}_{d}{b}" for k in ("gru", "lingru") for d in ("fwd", "bwd") for b in ("", "_bf16")}
    assert set(kernels.KERNELS) == names
    for name, (source, entry, _) in kernels.KERNELS.items():
        assert (PORT / source).is_file() and entry == f"roko_{name}", name
        want = torch.bfloat16 if name.endswith("_bf16") else torch.float32
        assert kernels.DTYPES[name] == want, name
    for wrapper in (fg.gru_recurrence, fg.gru_recurrence_backward, fl.lingru_scan,
                    fl.lingru_scan_backward):
        assert isinstance(wrapper.launches, int) and isinstance(wrapper.launches_bf16, int)
