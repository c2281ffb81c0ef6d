"""mixtral-8x22b's ``--smoke --mode train_periodic`` launcher run in the
port against the JAX package's on the CPU, as
``tests/test_torch_moe_launch.py`` holds its ``train_dynamic`` one (a
file of its own, for the test runner's ``--dist loadfile``).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_launch_train import check_launcher  # noqa: E402
from test_torch_moe_launch import LAUNCH_STEPS, MOE_ARCHS  # noqa: E402


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("mode", ["train_periodic"])
def test_moe_launcher_matches_reference(arch, mode, monkeypatch, capsys):
    check_launcher(arch, mode, monkeypatch, capsys, steps=LAUNCH_STEPS)
