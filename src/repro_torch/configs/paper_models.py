"""The paper's own model configurations (Appendix A) — the counterpart of
``repro.configs.paper_models``, field for field.

* ``mnist_cnn``      — Table 1: Conv32-Conv64-MaxPool-Dense128-Dense10
                       (1,199,882 weights).
* ``deepdrive_cnn``  — Table 5 (PilotNet, Bojarski et al.): 348,219 weights.
* ``drift_mlp``      — MLP for the d=50 random-graphical-model drift data.
"""
from repro_torch.config import ModelConfig, register_arch


def mnist_cnn():
    return ModelConfig(
        name="mnist_cnn", family="cnn",
        cnn_spec=(
            ("conv", 32, 3, 1),
            ("conv", 64, 3, 1),
            ("pool", 2),
            ("dropout", 0.25),
            ("flatten",),
            ("dense", 128),
            ("dropout", 0.5),
            ("dense", 10),
        ),
        input_shape=(28, 28, 1), num_outputs=10,
        source="Kamp et al. 2018, Table 1",
    )


def mnist_cnn_smoke():
    return ModelConfig(
        name="mnist_cnn_smoke", family="cnn",
        cnn_spec=(
            ("conv", 4, 3, 1),
            ("pool", 2),
            ("flatten",),
            ("dense", 16),
            ("dense", 10),
        ),
        input_shape=(14, 14, 1), num_outputs=10,
        source="Kamp et al. 2018, Table 1 (reduced)",
    )


def deepdrive_cnn():
    return ModelConfig(
        name="deepdrive_cnn", family="cnn",
        cnn_spec=(
            ("conv", 24, 5, 2),
            ("conv", 36, 5, 2),
            ("conv", 48, 5, 2),
            ("conv", 64, 3, 1),
            ("conv", 64, 3, 1),
            ("flatten",),
            ("dense", 100),
            ("dense", 50),
            ("dense", 10),
            ("dense", 1),
        ),
        input_shape=(68, 320, 3), num_outputs=1,   # (68,320) reproduces Table 5 shapes: conv1 out (32,158), flatten 2112
        source="Kamp et al. 2018, Table 5 / Bojarski et al. 2016",
    )


def deepdrive_cnn_smoke():
    return ModelConfig(
        name="deepdrive_cnn_smoke", family="cnn",
        cnn_spec=(
            ("conv", 8, 5, 2),
            ("conv", 8, 3, 1),
            ("flatten",),
            ("dense", 16),
            ("dense", 1),
        ),
        input_shape=(20, 40, 3), num_outputs=1,
        source="Kamp et al. 2018, Table 5 (reduced)",
    )


def drift_mlp():
    return ModelConfig(
        name="drift_mlp", family="cnn",
        cnn_spec=(
            ("flatten",),
            ("dense", 64),
            ("dense", 32),
            ("dense", 2),
        ),
        input_shape=(50,), num_outputs=2,
        source="Kamp et al. 2018, App. A.3 (Bshouty & Long data)",
    )


register_arch("mnist_cnn", mnist_cnn, mnist_cnn_smoke)
register_arch("deepdrive_cnn", deepdrive_cnn, deepdrive_cnn_smoke)
register_arch("drift_mlp", drift_mlp, drift_mlp)
