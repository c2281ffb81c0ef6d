"""The MoE fleet tests of ``tests/test_torch_moe_fleet.py`` on
deepseek-v2-236b-smoke (MLA, 16 experts, top 6, 2 shared): the learners'
vmap against each learner's own call, and the dynamic, periodic and
rematerialized fleets against the JAX package's jitted steps. A file of
its own, so that the test runner's ``--dist loadfile`` runs it beside
mixtral-8x22b's.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_lm_train import make_setup  # noqa: E402
from test_torch_moe_fleet import (  # noqa: E402,F401
    MOE_ARCHS,
    test_moe_fleet_steps_match_reference,
    test_moe_fleet_with_remat_matches_reference,
    test_vmap_matches_each_learner,
)


@pytest.fixture(scope="module", params=MOE_ARCHS[1:])
def setup(request):
    return make_setup(request.param)
