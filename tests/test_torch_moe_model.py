"""The two mixture-of-experts configs end to end against the JAX package
(``test_torch_modalities.zoo_parity``: logits, the auxiliary loss,
decode logits and caches, the engine's greedy tokens, at rtol 1e-4 /
atol 1e-5): mixtral-8x22b (sliding window, top-2 of 4 at the smoke
size) and deepseek-v2-236b (MLA, top-2 of 4 and one shared expert), at
the smoke configs' capacity factor 8 and at the default 1.25, where
tokens are dropped. ``moe_apply`` alone is in ``test_torch_moe.py``.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_modalities import smoke_pair, zoo_parity  # noqa: E402


@pytest.mark.parametrize("name", ["mixtral-8x22b", "deepseek-v2-236b"])
@pytest.mark.parametrize("cf", [None, 1.25])
def test_moe_model_matches_reference(name, cf):
    pair = smoke_pair(name, moe={"capacity_factor": cf}) if cf else \
        smoke_pair(name)
    zoo_parity(*pair, S=32)
