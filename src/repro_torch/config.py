"""Configuration for the port — its own copy of what the slice needs from
``repro.config``.

``ModelConfig`` keeps the fields of the paper's CNN/MLP families, of
the dense decoder LM (``repro/config.py:69-100``: GQA, optional QKV bias,
optional sliding window, text modality) and of the Mamba2 SSM decoder
(``ssm=SSMConfig(...)`` with ``block_type="ssm"``, ``repro/config.py:58``),
with ``resolved_head_dim``, ``is_attention_free`` and ``param_count()``.
Setting ``moe`` or ``mla``, a hybrid ``block_type``, or a vision/audio
``modality`` raises ``NotImplementedError`` naming the ROADMAP item that
ports it; the reference's ``moe_layer_period`` and ``scan_layers`` have
no port (the port's layer loop is a Python loop). ``TrainConfig`` keeps
the optimizer settings and ``ProtocolConfig`` the sync protocol.

``ProtocolConfig`` validates exactly as the reference does (the same
``ValueError``s for a bad period, fraction, threshold, augmentation,
payload size or layout) by resolving its preset through
``repro_torch.core.sync.spec``. It departs from the reference in three
ways: ``layout`` defaults to ``"flat"``, and ``"tree"`` runs on the same
``(m, P)`` plane; ``"sharded"`` and the async and robust kinds raise
``NotImplementedError`` naming the ROADMAP item that ports them; and the
hierarchy field ``tiers`` waits for its slice.

``NetworkConfig`` is the reference's simulated network environment
(``repro/config.py:394-500``), field for field, with the same
validation errors and the ``full_availability`` property; the
``TOPO_*``, ``TOPOLOGIES`` and ``LINK_CLASS_NAMES`` constants come with
it. The other environment configs (hierarchy, async, faults, telemetry)
wait for their slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple


BLOCK_ATTN = "attn"
BLOCK_SSM = "ssm"
BLOCK_HYBRID = "hybrid"

ATTN_FULL = "full"
ATTN_SLIDING = "sliding"

MODALITY_TEXT = "text"
MODALITY_VISION = "vision"
MODALITY_AUDIO = "audio"

# what this port does not run yet, and the ROADMAP Queue A item that ports it
NOT_PORTED_LM = {
    "moe": "mixture-of-experts FFNs (ROADMAP Queue A 23)",
    "mla": "multi-head latent attention (ROADMAP Queue A 23)",
    BLOCK_HYBRID: "hybrid attention + SSM blocks (ROADMAP Queue A 23)",
    MODALITY_VISION: "the vision modality (ROADMAP Queue A 23)",
    MODALITY_AUDIO: "the audio modality (ROADMAP Queue A 23)",
}


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD settings (``repro.config.SSMConfig``, field for
    field)."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 64
    ngroups: int = 1


@dataclass(frozen=True)
class ModelConfig:
    """One model: the paper's CNN/MLP (a ``cnn_spec`` of layer descriptors
    over per-example ``input_shape``, see ``repro_torch.models.cnn``), the
    dense decoder LM (``num_layers`` blocks of GQA attention and a SwiGLU
    FFN) or the Mamba2 decoder (``num_layers`` SSM blocks, no FFN); see
    ``repro_torch.models.model``."""
    name: str
    family: str                           # dense | ssm | cnn
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0                     # 0 -> d_model // num_heads
    block_type: str = BLOCK_ATTN
    attn_type: str = ATTN_FULL            # full | sliding
    sliding_window: int = 4096
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    modality: str = MODALITY_TEXT
    moe: Any = None                       # not ported: raises when set
    mla: Any = None
    ssm: Optional[SSMConfig] = None
    # CNN-only fields (the paper's MNIST / deep-driving nets)
    cnn_spec: Optional[Tuple[Any, ...]] = None
    input_shape: Optional[Tuple[int, ...]] = None   # per example
    num_outputs: int = 0
    dtype: str = "float32"
    source: str = ""                                # citation

    def __post_init__(self):
        for name in ("moe", "mla"):
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"{name}= is not ported yet: {NOT_PORTED_LM[name]}")
        if self.ssm is not None and not isinstance(self.ssm, SSMConfig):
            raise TypeError(f"ssm= takes an SSMConfig, got {self.ssm!r}")
        if self.block_type == BLOCK_SSM and self.ssm is None:
            raise ValueError("block_type='ssm' needs ssm=SSMConfig(...)")
        if self.block_type == BLOCK_HYBRID:
            raise NotImplementedError(
                f"block_type='hybrid' is not ported yet: "
                f"{NOT_PORTED_LM[BLOCK_HYBRID]}")
        if self.block_type not in (BLOCK_ATTN, BLOCK_SSM):
            raise ValueError(f"unknown block_type {self.block_type!r}")
        if self.modality in (MODALITY_VISION, MODALITY_AUDIO):
            raise NotImplementedError(
                f"modality={self.modality!r} is not ported yet: "
                f"{NOT_PORTED_LM[self.modality]}")
        if self.modality != MODALITY_TEXT:
            raise ValueError(f"unknown modality {self.modality!r}")
        if self.attn_type not in (ATTN_FULL, ATTN_SLIDING):
            raise ValueError(f"unknown attn_type {self.attn_type!r}")

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def is_attention_free(self) -> bool:
        return self.block_type == BLOCK_SSM

    def param_count(self) -> int:
        """Analytic parameter count of the LM (embedding + blocks + head),
        as ``repro.config.ModelConfig.param_count`` counts a dense GQA or
        an SSM decoder, term for term; -1 for the CNN family (count the
        tree instead).

        Like the reference's, the count leaves out ``final_norm`` (d).
        For an SSM block it counts two norms where the block has one
        (``norm_mix``: there is no FFN) and leaves out ``dt_bias`` (H)
        and ``out_norm`` (d_inner), so the tree holds
        ``L * (H + d_inner - d) + d`` more weights than this: 171,520 for
        mamba2-2.7b (2,830,780,416 counted, 2,830,951,936 held)."""
        if self.family == "cnn":
            return -1
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 2 * d                                   # norms
        if self.block_type == BLOCK_ATTN:
            per_layer += d * self.num_heads * hd            # q
            per_layer += 2 * d * self.num_kv_heads * hd     # k, v
            per_layer += self.num_heads * hd * d            # o
            if self.qkv_bias:
                per_layer += (self.num_heads + 2 * self.num_kv_heads) * hd
        if self.block_type == BLOCK_SSM:
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            per_layer += d * 2 * d_in                       # in proj (x, z)
            per_layer += d * (2 * s.ngroups * s.d_state + nheads)  # B, C, dt
            per_layer += s.d_conv * (d_in + 2 * s.ngroups * s.d_state)
            per_layer += nheads * 2                         # A_log, D
            per_layer += d_in * d                           # out proj
        if self.d_ff:
            per_layer += 3 * d * self.d_ff                  # swiglu
        return n + self.num_layers * per_layer


@dataclass(frozen=True)
class ProtocolConfig:
    """Synchronization protocol Π = (φ, σ).

    ``kind`` selects the operator σ; ``b`` is the check/sync period in
    local steps; ``delta`` the divergence threshold Δ for σ_Δ;
    ``fedavg_c`` the FedAvg fraction C; ``augmentation`` the
    coordinator's balancing strategy for dynamic averaging; ``weighted``
    turns on Algorithm 2's B^i weights; ``bytes_per_param`` prices a
    model transfer; ``layout`` the fleet arithmetic (``"flat"``: one
    ``(m, P)`` plane)."""
    kind: str = "dynamic"
    b: int = 10
    delta: float = 0.5
    fedavg_c: float = 0.3
    augmentation: str = "max_distance"   # max_distance | random | all
    weighted: bool = False               # Algorithm 2 (unbalanced B^i)
    bytes_per_param: int = 4
    layout: str = "flat"                 # flat | tree (the same plane)

    def __post_init__(self):
        if self.b < 1:
            raise ValueError(f"sync period b must be >= 1, got {self.b!r}")
        if not 0.0 < self.fedavg_c <= 1.0:
            raise ValueError(
                f"fedavg_c must be in (0, 1], got {self.fedavg_c!r}")
        # resolving the preset validates the kind and the parameters its
        # stages consume, as in the reference
        self._spec()

    def _spec(self):
        from repro_torch.core.sync.spec import resolve_spec
        return resolve_spec(self)


# ---------------------------------------------------------------------------
# Network environment (topology, availability, link costs)
# ---------------------------------------------------------------------------

TOPO_STAR = "star"
TOPO_RING = "ring"
TOPO_TORUS = "torus"
TOPO_ERDOS_RENYI = "erdos_renyi"
TOPO_GEOMETRIC = "geometric"

TOPOLOGIES = (
    TOPO_STAR, TOPO_RING, TOPO_TORUS, TOPO_ERDOS_RENYI, TOPO_GEOMETRIC,
)

# the link classes a config may name; ``repro_torch.network.cost`` prices
# exactly these (it checks the two registries are in lockstep)
LINK_CLASS_NAMES = ("wired", "wifi", "lte", "edge")


@dataclass(frozen=True)
class NetworkConfig:
    """Simulated network environment for a fleet of learners
    (``repro_torch.network``).

    * **topology** — the peer overlay, an (m, m) symmetric adjacency:
      ``star`` | ``ring`` | ``torus`` | ``erdos_renyi`` | ``geometric``;
      ``geometric`` with ``redraw_every=k`` re-draws node positions every
      k rounds (mobility). Coordinator protocols read only availability;
      the overlay governs ``gossip``.
    * **availability** — per-round (m,) active masks: i.i.d. ``act_prob``
      dropout, a ``straggler_frac`` subset at ``straggler_act_prob``, and
      scheduled outages (every ``outage_every`` rounds an ``outage_frac``
      of the fleet goes dark for ``outage_length`` rounds). Unavailable
      learners keep training but cannot communicate.
    * **link costs** — per-learner bandwidth/latency classes assigned
      round-robin from ``link_classes``; transfers become simulated
      seconds a round and per-link bytes.
    """
    topology: str = TOPO_STAR
    er_p: float = 0.3                    # Erdős–Rényi edge probability
    geo_radius: float = 0.5              # geometric radius in [0,1]^2
    redraw_every: int = 0                # >0: re-draw geometric graph
    act_prob: float = 1.0                # Bernoulli availability
    straggler_frac: float = 0.0          # fraction of learners straggling
    straggler_act_prob: float = 0.5      # their (lower) availability
    outage_every: int = 0                # 0 = no scheduled outages
    outage_length: int = 1               # rounds an outage lasts
    outage_frac: float = 0.25            # fraction of fleet taken down
    link_classes: Tuple[str, ...] = ("wired",)
    msg_bytes: int = 64                  # control-message size
    seed: int = 0

    def __post_init__(self):
        if self.topology not in TOPOLOGIES:
            raise KeyError(
                f"unknown topology {self.topology!r}; "
                f"known: {sorted(TOPOLOGIES)}")
        if not 0.0 <= self.er_p <= 1.0:
            raise ValueError(
                f"er_p is an edge probability, must be in [0, 1]: "
                f"got {self.er_p!r}")
        if not self.geo_radius > 0.0:
            raise ValueError(
                f"geo_radius must be > 0, got {self.geo_radius!r}")
        if self.redraw_every < 0:
            raise ValueError(
                f"redraw_every must be >= 0 (0 = static graph), "
                f"got {self.redraw_every!r}")
        if self.redraw_every != 0 and self.topology != TOPO_GEOMETRIC:
            raise ValueError(
                f"redraw_every only applies to topology='geometric', "
                f"got {self.topology!r}")
        if not 0.0 < self.act_prob <= 1.0:
            raise ValueError(
                f"act_prob is a per-round availability probability, must "
                f"be in (0, 1]: got {self.act_prob!r}")
        if not 0.0 <= self.straggler_frac <= 1.0:
            raise ValueError(
                f"straggler_frac must be in [0, 1], "
                f"got {self.straggler_frac!r}")
        if not 0.0 < self.straggler_act_prob <= 1.0:
            raise ValueError(
                f"straggler_act_prob must be in (0, 1], "
                f"got {self.straggler_act_prob!r}")
        if self.outage_every < 0:
            raise ValueError(
                f"outage_every must be >= 0 (0 = no outages), "
                f"got {self.outage_every!r}")
        if self.outage_length < 1:
            raise ValueError(
                f"outage_length must be >= 1 round, "
                f"got {self.outage_length!r}")
        if self.outage_every != 0 and self.outage_length > self.outage_every:
            raise ValueError(
                f"outage_length ({self.outage_length}) must not exceed "
                f"outage_every ({self.outage_every}) — that is a permanent "
                f"blackout, not a scheduled outage")
        if not 0.0 <= self.outage_frac <= 1.0:
            raise ValueError(
                f"outage_frac must be in [0, 1], got {self.outage_frac!r}")
        if len(self.link_classes) < 1:
            raise ValueError(
                "link_classes must name at least one link class "
                "(assigned round-robin over the learner index)")
        unknown = [c for c in self.link_classes if c not in LINK_CLASS_NAMES]
        if unknown:
            raise KeyError(
                f"unknown link class(es) {unknown}; "
                f"known: {sorted(LINK_CLASS_NAMES)}")

    @property
    def full_availability(self) -> bool:
        """True when every learner is reachable every round: the engine
        then samples no masks (the pre-network path, bitwise)."""
        return (self.act_prob >= 1.0 and self.straggler_frac == 0.0
                and self.outage_every == 0)


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "sgd"                 # sgd | momentum | adam | rmsprop
    learning_rate: float = 0.1
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    seed: int = 0


_ARCH_REGISTRY: dict = {}


def register_arch(name: str, full_fn, smoke_fn) -> None:
    _ARCH_REGISTRY[name] = (full_fn, smoke_fn)


def get_arch(name: str, smoke: bool = False) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers registration)
    if name not in _ARCH_REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(_ARCH_REGISTRY)}")
    full_fn, smoke_fn = _ARCH_REGISTRY[name]
    return smoke_fn() if smoke else full_fn()

