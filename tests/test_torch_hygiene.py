"""Import hygiene and device rules of the PyTorch port.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
  package (an AST scan), and importing the port leaves ``jax`` out of
  ``sys.modules`` (a fresh subprocess).
* Entry points (``stitched_jit``, ``Model`` and so ``generate``,
  ``serve.main``, ``build_trainer`` and ``train.main``) default to CUDA: on a host without one they raise unless
  the caller passes ``device="cpu"``; they never move to the CPU silently.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import stitched_jit  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.core, "
            "repro_torch.models.model, repro_torch.models.convert, "
            "repro_torch.kernels.ops, repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.optim, repro_torch.data, "
            "repro_torch.core.plan_cache, repro_torch.core.autotune, "
            "repro_torch.runtime, repro_torch.serving.scheduler; "
            "print('jax' in sys.modules, 'repro' in sys.modules)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert out == ["False", "False"]


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")


def test_stitched_jit_defaults_to_cuda_and_raises_without_it():
    _no_cuda()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stitched_jit(lambda x: x * 2.0)
    f = stitched_jit(lambda x: x * 2.0, device="cpu")
    torch.testing.assert_close(f(torch.ones(4, 8)), torch.full((4, 8), 2.0))


def test_model_defaults_to_cuda_and_raises_without_it():
    _no_cuda()
    cfg = get_config("llama3.2-3b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    assert Model(cfg, device="cpu").device.type == "cpu"


def test_serve_defaults_to_cuda_and_raises_without_it():
    _no_cuda()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced"])


def test_train_defaults_to_cuda_and_raises_without_it():
    _no_cuda()
    cfg = get_config("hubert-xlarge").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.build_trainer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "hubert-xlarge", "--reduced", "--steps", "1"])


def test_inputs_on_another_device_are_refused():
    f = stitched_jit(lambda x: x + 1.0, device="cpu")
    with pytest.raises(ValueError, match="runs on cpu"):
        f(torch.ones(2, 2, device="meta"))
