"""The protocol training loop and the single-model step — the
counterpart of ``repro.train``."""
from repro_torch.train.step import TrainState, make_train_step  # noqa: F401
from repro_torch.train.loop import run_protocol_training  # noqa: F401
