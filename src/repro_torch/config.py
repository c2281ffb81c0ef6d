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
``repro_torch.core.sync.spec``; ``tiers`` (a ``HierarchyConfig``) makes
it the intra tier of a two-tier hierarchy. It departs from the reference
in one way: ``layout`` defaults to ``"flat"``, and ``"tree"`` runs on the
same ``(m, P)`` plane. ``"sharded"`` splits the plane's rows over the
ranks of a ``torch.distributed`` process group
(``repro_torch.core.shard``), and ``shard_devices`` caps how many ranks
the fleet uses, with the reference's validation.

``NetworkConfig`` (``repro/config.py:394-500``), ``HierarchyConfig``
(``:329-369``), ``AsyncConfig`` (``:507-546``), ``FaultConfig``
(``:553-644``, with ``FAULT_BYZANTINE_MODES``) and ``TelemetryConfig``
(``:646-678``) are the reference's, field for field, with the same
validation errors; the ``TOPO_*``, ``TOPOLOGIES`` and
``LINK_CLASS_NAMES`` constants come with them. ``TelemetryConfig``
renames one field: the reference's ``jax_profiler`` is ``profiler``.
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
    ``(m, P)`` plane; ``"sharded"``: its rows split over the ranks of a
    process group). ``shard_devices`` caps how many ranks the sharded
    fleet uses (0 = all); ``m % n_devices`` must be 0 — every rank owns
    the same number of learner rows."""
    kind: str = "dynamic"
    b: int = 10
    delta: float = 0.5
    fedavg_c: float = 0.3
    augmentation: str = "max_distance"   # max_distance | random | all
    weighted: bool = False               # Algorithm 2 (unbalanced B^i)
    bytes_per_param: int = 4
    layout: str = "flat"                 # flat | tree | sharded
    shard_devices: int = 0               # sharded: rank cap, 0 = all
    tiers: Optional["HierarchyConfig"] = None   # two-tier hierarchy on top

    def __post_init__(self):
        if self.b < 1:
            raise ValueError(f"sync period b must be >= 1, got {self.b!r}")
        if not 0.0 < self.fedavg_c <= 1.0:
            raise ValueError(
                f"fedavg_c must be in (0, 1], got {self.fedavg_c!r}")
        # resolving the preset validates the kind and the parameters its
        # stages consume, as in the reference
        spec = self._spec()
        if self.tiers is not None and not spec.uses_coordinator:
            raise ValueError(
                f"{self.kind} cannot be the intra-tier operator of a "
                "hierarchy: it has no coordinator — a cluster's members "
                "talk to their edge aggregator over uplinks. Use a "
                "coordinator protocol (periodic/fedavg/dynamic) per tier.")

    def _spec(self):
        from repro_torch.core.sync.spec import resolve_spec
        return resolve_spec(self)


@dataclass(frozen=True)
class HierarchyConfig:
    """Two-tier star-of-stars coordinator hierarchy
    (``repro_torch.core.sync.hierarchy``).

    The fleet is partitioned into ``num_clusters`` contiguous, equal-size
    clusters (the engine rejects ``m % num_clusters != 0``). The enclosing
    ``ProtocolConfig`` runs inside every cluster (members and their edge
    aggregator), the aggregator model is the availability-masked cluster
    mean, and ``inter`` runs among the aggregators with its own cadence,
    threshold and payload size (``bytes_per_param``: a quantized
    backhaul). ``link_class`` is the aggregator uplinks' class in the
    network cost model."""
    num_clusters: int
    inter: ProtocolConfig
    link_class: str = "wired"

    def __post_init__(self):
        if self.num_clusters < 2:
            raise ValueError(
                f"a hierarchy needs >= 2 clusters, got {self.num_clusters} "
                "(one cluster is just the flat protocol — drop tiers=)")
        if not self.inter._spec().uses_coordinator:
            raise ValueError(
                f"the inter-tier operator cannot be {self.inter.kind}: "
                "edge aggregators talk to the top coordinator over a star "
                "of uplinks, not a peer overlay. Use a coordinator "
                "protocol (periodic/fedavg/dynamic/nosync).")
        if self.inter.tiers is not None:
            raise ValueError(
                "hierarchies do not nest: tiers.inter must have tiers=None "
                "(the hierarchy is exactly two tiers).")
        if self.link_class not in LINK_CLASS_NAMES:
            raise KeyError(
                f"unknown aggregator link class {self.link_class!r}; "
                f"known: {sorted(LINK_CLASS_NAMES)}")


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
class AsyncConfig:
    """The event-driven network timeline (``repro_torch.network.events``
    and ``repro_torch.core.sync.async_sync``). Attached to a
    ``DecentralizedLearner`` it rewrites the protocol's trigger onto
    per-learner local clocks with messages in flight: each sync exchange
    flies ``k = ceil(round_trip / round_budget) - 1`` whole rounds, the
    round trip priced from the ``NetworkConfig`` link classes and the
    payload (``payload_bytes``; None = the model's own byte size). A
    budget covering the slowest round trip is the synchronous engine, bit
    for bit. ``aircomp`` swaps the mean/average pair for the over-the-air
    stages: Gaussian receiver noise ``snr_db`` below the aggregate's RMS,
    drawn purely from ``(air_seed, t)``."""
    round_budget: float = 1.0     # simulated seconds per round
    max_delay: int = 8            # arrival-ring depth (max flight rounds + 1)
    payload_bytes: Optional[int] = None   # None = the engine's model_bytes
    aircomp: bool = False         # swap mean/average -> over-the-air stages
    snr_db: float = 20.0          # receiver SNR below the aggregate's RMS
    air_seed: int = 0             # noise stream seed (pure in (seed, t))

    def __post_init__(self):
        if not self.round_budget > 0:
            raise ValueError(
                f"round_budget must be > 0 simulated seconds, "
                f"got {self.round_budget!r}")
        if self.max_delay < 1:
            raise ValueError(
                f"max_delay must be >= 1 round, got {self.max_delay!r}")
        if self.payload_bytes is not None and self.payload_bytes < 0:
            raise ValueError(
                f"payload_bytes must be >= 0 (or None for the model's "
                f"size), got {self.payload_bytes!r}")


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------

FAULT_BYZANTINE_MODES = ("sign_flip", "scale")


@dataclass(frozen=True)
class FaultConfig:
    """The fault-injection plane (``repro_torch.network.faults``),
    threaded through the engine like ``NetworkConfig``/``AsyncConfig``.
    Every mask is a pure function of ``(fault_seed, t)``:

    * **crash/restart episodes** — time is cut into windows of
      ``crash_every`` rounds; in each window a learner crashes with
      probability ``crash_prob`` at a sampled offset for a sampled
      ``outage_min..outage_max``-round outage. While crashed it neither
      trains nor participates (the crash mask composes with the
      availability mask); on restart it rejoins COLD — params, optimizer
      state, and per-learner sync state (staleness counters, arrival
      rings, health) are zeroed, modeling a node that lost local state.
    * **payload corruption** — each round each learner's parameters go
      non-finite with probability ``corrupt_prob`` (NaN on odd rounds,
      Inf on even), the silent poison a plain ``mean`` spreads forever.
    * **Byzantine adversaries** — a fixed ``byzantine_frac`` subset
      (drawn once from ``fault_seed``) replaces its parameters every
      round: ``sign_flip`` negates them, ``scale`` multiplies by
      ``byzantine_scale``.
    * **straggler bursts** — in each ``straggler_every``-round window,
      with probability ``straggler_prob``, a random ``straggler_frac``
      of the fleet goes dark for the window (AND-composed with the
      availability mask like a crash, but without state loss).

    ``faults=None`` runs no fault code at all; a default ``FaultConfig()``
    has every fault disabled and gives the ``faults=None`` results bit
    for bit. Defenses are registered stages
    (``repro_torch.core.sync.robust``)."""
    fault_seed: int = 0
    crash_prob: float = 0.0       # per-learner per-window crash probability
    crash_every: int = 16         # episode window length (rounds)
    outage_min: int = 1           # shortest outage (rounds)
    outage_max: int = 4           # longest outage (rounds)
    corrupt_prob: float = 0.0     # per-learner per-round NaN/Inf corruption
    byzantine_frac: float = 0.0   # fraction of the fleet that is adversarial
    byzantine_mode: str = "sign_flip"   # sign_flip | scale
    byzantine_scale: float = 10.0       # multiplier for mode="scale"
    straggler_prob: float = 0.0   # per-window burst probability
    straggler_every: int = 8      # burst window length (rounds)
    straggler_frac: float = 0.5   # fraction straggling during a burst

    def __post_init__(self):
        for name in ("crash_prob", "corrupt_prob", "straggler_prob",
                     "straggler_frac"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(
                    f"{name} is a probability/fraction, must be in "
                    f"[0, 1]: got {v!r}")
        if not 0.0 <= self.byzantine_frac < 1.0:
            raise ValueError(
                f"byzantine_frac must be in [0, 1) — a fully adversarial "
                f"fleet has nothing to defend; got {self.byzantine_frac!r}")
        if self.byzantine_mode not in FAULT_BYZANTINE_MODES:
            raise KeyError(
                f"unknown byzantine_mode {self.byzantine_mode!r}; "
                f"known: {sorted(FAULT_BYZANTINE_MODES)}")
        if self.crash_every < 1:
            raise ValueError(
                f"crash_every must be >= 1 round, got {self.crash_every!r}")
        if self.straggler_every < 1:
            raise ValueError(
                f"straggler_every must be >= 1 round, "
                f"got {self.straggler_every!r}")
        if not 1 <= self.outage_min <= self.outage_max:
            raise ValueError(
                f"need 1 <= outage_min <= outage_max, got "
                f"outage_min={self.outage_min!r}, "
                f"outage_max={self.outage_max!r}")
        if self.outage_max > self.crash_every:
            raise ValueError(
                f"outage_max ({self.outage_max}) must not exceed "
                f"crash_every ({self.crash_every}) — a crash outliving its "
                f"episode window is a permanent loss, not a restart")


# ---------------------------------------------------------------------------
# Telemetry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TelemetryConfig:
    """The fleet telemetry plane (``repro_torch.telemetry``).

    Attached to a ``DecentralizedLearner`` (directly or through
    ``run_protocol_training(telemetry=...)``) it streams a schema'd round
    record per executed round — loss, divergence, trigger accounting,
    cohort size, reachability, simulated net-time, exact cumulative bytes
    — to ``path`` as JSONL, with the newest ``ring`` records also held in
    memory. Records are built on the host from the values each chunk
    already fetches. ``telemetry=None`` leaves the engine as it is.

    ``per_link`` adds the per-link byte vector to every round record.
    ``profile`` adds wall-clock and first-call accounting per chunk.
    ``profiler`` (the reference's ``jax_profiler``) names each chunk in
    a ``torch.profiler`` trace with ``record_function`` (a no-op unless
    a trace is active)."""
    path: Optional[str] = None    # JSONL sink; None = ring buffer only
    append: bool = False          # append to path (checkpoint resume)
    ring: int = 1024              # in-memory ring capacity (records)
    per_link: bool = False        # per-link bytes on every round record
    profile: bool = False         # wall-clock + first-call spans per chunk
    profiler: bool = False        # torch.profiler chunk annotations

    def __post_init__(self):
        if self.ring < 1:
            raise ValueError(
                f"ring must hold >= 1 record, got {self.ring!r}")


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

