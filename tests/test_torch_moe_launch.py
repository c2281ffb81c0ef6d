"""The launcher twin's MoE fleets against the JAX package's launcher on
the CPU: ``--smoke --mode train_dynamic`` of mixtral-8x22b in both
packages, through ``tests/test_torch_launch_train.py``'s
``check_launcher`` (the same events, keys, steps, ``mode`` and ``arch``,
finite falling losses). Before ``models/moe.py``'s routing batched under
the learners' vmap, the port's fleet modes raised here for both MoE
archs. mixtral-8x22b's ``train_periodic`` case is in
``tests/test_torch_moe_launch_periodic.py`` and deepseek-v2-236b's two
cases in ``tests/test_torch_moe_launch_deepseek.py``: a file each (two
minutes each on the CPU), so that the test runner's ``--dist loadfile``
spreads them over the workers.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_launch_train import check_launcher  # noqa: E402

MOE_ARCHS = ("mixtral-8x22b",)
# over 12 steps (the llama3-8b case's) the reference's own mixtral-smoke
# loss rises at the launcher's adam lr 1e-3; over 30 both packages'
# losses fall for both archs (jax 0.9.0, torch 2.13 on the CPU)
LAUNCH_STEPS = 30


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("mode", ["train_dynamic"])
def test_moe_launcher_matches_reference(arch, mode, monkeypatch, capsys):
    check_launcher(arch, mode, monkeypatch, capsys, steps=LAUNCH_STEPS)
