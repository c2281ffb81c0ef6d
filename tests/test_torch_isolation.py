"""The port stands apart from the JAX package.

``src/repro_torch``, ``chip_smoke.py`` and the port's examples
(``examples/torch_quickstart.py``, ``examples/torch_network_regimes.py``)
import torch and numpy, never
jax and nothing of ``repro``; the port's entry points run on the card by
default and raise, rather than fall back to the CPU, when there is none.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.config import ProtocolConfig, get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.protocol import DecentralizedLearner  # noqa: E402
from repro_torch.data.synthetic import SyntheticMNIST  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.cnn import cnn_loss, init_cnn_params  # noqa: E402
from repro_torch.models.model import init_lm_params  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train.loop import run_protocol_training  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "torch_quickstart.py",
    ROOT / "examples" / "torch_network_regimes.py"]


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import sys\n"
        f"for name in {list(_modules())!r}:\n"
        "    __import__(name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith(('jax.', 'jaxlib')) or n == 'repro' or "
        "n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= len(list(_modules()))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_source_imports_jax_or_the_reference(path):
    bad = [name for name in _imports(path)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _need_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; this checks the CPU-only path")


def test_entry_points_default_to_the_card_and_raise_without_one():
    _need_no_card()
    cfg = get_arch("drift_mlp")
    args = (lambda p, b: cnn_loss(cfg, p, b),
            lambda g: init_cnn_params(cfg, g), 3,
            ProtocolConfig(kind="periodic", b=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecentralizedLearner(*args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticMNIST()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    dl = DecentralizedLearner(*args, device="cpu")
    assert dl.X.device.type == "cpu"
    tree = {"w": np.ones((2, 3), np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(tree)
    assert params_from_numpy(tree, device="cpu")["w"].device.type == "cpu"
    lm = get_arch("llama3-8b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_lm_params(lm)
    params = init_lm_params(lm, device="cpu")
    assert params["embed"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(lm, params, max_seq=4, batch=1)
    eng = ServeEngine(lm, params, max_seq=4, batch=1, device="cpu")
    assert eng.cache["attn"]["k"].device.type == "cpu"


def test_ssm_entry_points_default_to_the_card_and_raise_without_one():
    _need_no_card()
    cfg = get_arch("mamba2-2.7b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_lm_params(cfg)
    params = init_lm_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, max_seq=4, batch=1)
    eng = ServeEngine(cfg, params, max_seq=4, batch=1, device="cpu")
    assert eng.cache["ssm"]["ssm"].device.type == "cpu"


def test_run_protocol_training_raises_without_a_card():
    _need_no_card()
    cfg = get_arch("mnist_cnn", smoke=True)
    src = SyntheticMNIST(image_size=14, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_protocol_training(lambda p, b: cnn_loss(cfg, p, b),
                              lambda g: init_cnn_params(cfg, g), src, m=2,
                              rounds=2, protocol=ProtocolConfig(kind="nosync"))


def test_paper_entry_points_default_to_the_card_and_raise_without_one():
    _need_no_card()
    from repro_torch import prng
    from repro_torch.core.protocol import SerialLearner
    from repro_torch.data.synthetic import (
        DeepDriveStream, GraphicalModelStream,
    )
    cfg = get_arch("drift_mlp")
    for make in (GraphicalModelStream, DeepDriveStream,
                 lambda: SerialLearner(lambda p, b: cnn_loss(cfg, p, b),
                                       lambda g: init_cnn_params(cfg, g)),
                 lambda: prng.key(0),
                 lambda: prng.split(prng.key(0, device="cpu")),
                 lambda: DecentralizedLearner(
                     lambda p, b: cnn_loss(cfg, p, b),
                     lambda g: init_cnn_params(cfg, g), 2,
                     ProtocolConfig(kind="fedavg", b=2),
                     init_heterogeneity=1.0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert GraphicalModelStream(device="cpu").W.device.type == "cpu"
    assert prng.key(0, device="cpu").device.type == "cpu"


def test_unknown_devices_are_rejected():
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        resolve_device("meta")


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Alone in a directory, or without a card, the script fails and
    prints no result."""
    _need_no_card()
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, lone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert out.stdout == ""
