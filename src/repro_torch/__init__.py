"""repro_torch: the PyTorch/CUDA port of ``repro`` (dynamic model averaging,
Kamp et al. 2018) for one NVIDIA H100.

Module paths mirror ``src/repro/`` (``repro.core.sync.stages`` <->
``repro_torch.core.sync.stages``), and each module's docstring names its
reference. The port imports torch and numpy only — never jax and nothing
of the ``repro`` package. Its entry points default to ``device="cuda"``
and raise when no card is visible; pass ``device="cpu"`` to run the plain
versions of the kernels on the CPU.

Slice 1 ported the paper's training path: m learners, the flat
``(m, P)`` fleet plane, the nosync/periodic/continuous/dynamic
protocols on an ideal network, and the ``sqdist_rows`` kernel. Slice 2
ported serving the dense GQA decoder LM (llama3-8b and its
sliding-window variant: ``serve.engine`` over ``models.model``) and the
``rmsnorm``, ``flash_attention`` and ``swa_attention`` kernels. Slice 3
ported serving the Mamba2 SSM decoder (mamba2-2.7b: ``models.mamba`` and
the SSM block, the same engine over O(1) SSM and conv states) and the
``ssd_scan`` kernel, the last of the reference's TPU kernels. Slice 6
finished the paper's experiments: ``prng`` (jax's threefry stream, bit
for bit), FedAvg, the random balancing augmentation, heterogeneous
initialization, the serial baseline (``SerialLearner``), the drifting
sources (``GraphicalModelStream``, ``DeepDriveStream``) and concept
drift in the training loop. Slice 7 ported the network environment
(``network``: availability masks, peer topologies, link costs) with
availability-aware stages, the gossip preset, bounded staleness and
``layout="tree"`` on the plane. Slice 8 ported checkpoints
(``checkpoint``), the two-tier hierarchy and the event-driven timeline.
Slice 9 ported the fault plane (``network.faults``), Byzantine-robust
sync (``core.sync.robust``) and the telemetry plane (``telemetry``).
"""
