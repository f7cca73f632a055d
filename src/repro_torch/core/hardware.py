"""Hardware profiles for the SmartSplit cost models.

Two families of profiles live behind one abstraction:

* paper-faithful smartphone/cloud profiles (Samsung J6, Redmi Note 8,
  the paper's Windows i5 server, 10 Mbps Wi-Fi) with the paper's energy
  constants (k = 1.172, Huang et al. radio model), used to reproduce
  Tables I/II and Figures 6-10;
* NVIDIA H100 pod-tier profiles (an edge pod and a cloud pod of H100
  SXM cards, joined by an InfiniBand NDR link), used by the beyond-paper
  two-tier partitioner.

This module is the port's one home of the H100's constants: the data
sheet's peaks, and the energy constants measured on the card by
``analysis/energy.py``'s calibration (marginal energy above the idle
floor).  The link energies are estimates that one card cannot measure;
each says so where it is defined.  Every benchmark records which profile
produced its numbers.
"""
from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# NVIDIA H100 SXM constants (data sheet, dense rates without sparsity, at
# the 700 W power limit).  fp32 is the CUDA cores' rate, which the port
# runs under ``device.strict_fp32`` (no TF32); bf16 the tensor cores'.
# tf32 is the tensor cores' TF32 rate, which the hand-written kernels'
# 3xTF32 passes run at (no record or tier computes in it).
# ---------------------------------------------------------------------------
H100_PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "tf32": 495e12}
H100_HBM_BW = 3.35e12               # bytes/s a card (HBM3)
H100_HBM_BYTES = 80e9               # bytes of HBM a card
H100_NVLINK_BW = 450e9              # bytes/s a direction (NVLink 4, 900 GB/s both)
# Between pods: one InfiniBand NDR port, 400 Gb/s (NVIDIA ConnectX-7
# adapter data sheet).
IB_NDR_BW = 400e9 / 8               # bytes/s

# Energy, measured on the card: the marginal energy above the idle floor,
# (E - P_idle * t) / work, from NVML's energy counter around an 8192^3
# GEMM (fp32 under strict_fp32; bf16, which runs at the power limit) and
# a 4 GiB device-to-device copy (2 bytes moved a byte copied), and the
# idle floor with a context up.  Each is the median of seven whole
# calibrations on three machines, each card "NVIDIA H100 80GB HBM3,
# 700.00 W" (``nvidia-smi --query-gpu=name,power.limit
# --format=csv,noheader``): six by
#     python3 scripts/energy_calibrate.py --runs 3
# (run twice) and one by ``chip_smoke.py``'s phase 14, which fails when
# a measurement leaves its ``ENERGY_BAND`` around these.  Spread of the
# seven, (max - min) / median: idle 22%, fp32 3.0%, bf16 3.8%, HBM 13%.
H100_PJ_PER_FLOP = {"fp32": 10.67, "bf16": 0.814}
H100_PJ_PER_HBM_BYTE = 128.1
H100_IDLE_W = 139.1
# Link energy: not measured -- NVLink needs two cards, the inter-pod
# network two nodes.  Both are unmeasured estimates kept from the JAX
# package's energy model (a serdes hop ~10 pJ/B; an optical network hop
# with its NICs ~40 pJ/B), not the card's numbers.
NVLINK_PJ_PER_BYTE_ESTIMATE = 10.0
IB_PJ_PER_BYTE_ESTIMATE = 40.0


@dataclasses.dataclass(frozen=True)
class DeviceTier:
    """One side of the split (paper: smartphone or cloud server).

    The paper's compute model is latency = M|l / (cores * speed): a
    memory-as-work proxy over cores x clock.  ``compute_scale`` is the
    (cores * speed) denominator in *bytes per second* equivalents for the
    paper profile; a pod profile instead fills peak_flops/hbm_bw and the
    cost model uses a per-layer roofline (see core/costs.py).
    """

    name: str
    cores: int
    speed_hz: float                 # per-core clock (paper model)
    memory_budget: float            # bytes available to the app (constraint M)
    # Roofline terms (pod tiers; 0 => use the paper cores*speed model).
    chips: int = 0
    peak_flops: float = 0.0
    hbm_bw: float = 0.0
    # Energy model. Paper client: P = k * cores * nu^3 (nu in GHz, P in W).
    energy_k: float = 0.0
    # Pod tier energy.
    pj_per_flop: float = 0.0
    pj_per_hbm_byte: float = 0.0

    @property
    def compute_scale(self) -> float:
        """cores * speed -- denominator of Eq. 2/3 (paper model)."""
        return self.cores * self.speed_hz

    @property
    def is_roofline(self) -> bool:
        return self.peak_flops > 0.0

    def compute_power_w(self) -> float:
        """Paper Eq. 6: P_client = k * C * nu^3 with nu in GHz."""
        nu_ghz = self.speed_hz / 1e9
        return self.energy_k * self.cores * nu_ghz**3


@dataclasses.dataclass(frozen=True)
class LinkProfile:
    """The client->server transport (paper: Wi-Fi; pods: InfiniBand)."""

    name: str
    bandwidth: float                # bytes/s (paper B, converted from Mbps)
    # Paper radio power model (Huang et al.): P = alpha * tau + beta, with
    # tau the throughput in Mbps and P in mW.
    alpha_up_mw_per_mbps: float = 0.0
    alpha_down_mw_per_mbps: float = 0.0
    beta_mw: float = 0.0
    # Pod link energy.
    pj_per_byte: float = 0.0

    def upload_power_w(self, throughput_bytes_s: float) -> float:
        mbps = throughput_bytes_s * 8 / 1e6
        return (self.alpha_up_mw_per_mbps * mbps + self.beta_mw) / 1e3

    def download_power_w(self, throughput_bytes_s: float) -> float:
        mbps = throughput_bytes_s * 8 / 1e6
        return (self.alpha_down_mw_per_mbps * mbps + self.beta_mw) / 1e3


@dataclasses.dataclass(frozen=True)
class TwoTierHardware:
    """Full client/link/server environment the optimiser plans against."""

    client: DeviceTier
    server: DeviceTier
    link: LinkProfile
    download_bytes: float = 4096.0  # result payload d (paper Eq. 11)

    def with_link_bandwidth(self, bandwidth: float) -> "TwoTierHardware":
        """The same environment under a different link bandwidth (bytes/s)
        -- the runtime re-pick path re-evaluates the cached Pareto front
        against this instead of mutating the planning profile."""
        if bandwidth <= 0:
            raise ValueError(f"bandwidth must be positive, got {bandwidth}")
        link = dataclasses.replace(self.link, bandwidth=float(bandwidth))
        return dataclasses.replace(self, link=link)


@dataclasses.dataclass(frozen=True)
class ChainHardware:
    """K tiers connected by K-1 links -- the N-tier deployment shape
    (device -> edge -> regional -> core).  ``TwoTierHardware`` is the
    K=2 degenerate instance (see ``chain_of``); the chain planner
    (``core.multicut.smartsplit_chain``) and the chain runtime
    (``runtime.ChainRuntime``) both consume this."""

    tiers: tuple[DeviceTier, ...]
    links: tuple[LinkProfile, ...]
    download_bytes: float = 4096.0  # result payload d (paper Eq. 11)

    def __post_init__(self):
        if len(self.tiers) < 2:
            raise ValueError(
                f"ChainHardware needs >= 2 tiers, got {len(self.tiers)}")
        if len(self.links) != len(self.tiers) - 1:
            raise ValueError(
                f"ChainHardware tier/link mismatch: {len(self.tiers)} "
                f"tiers need {len(self.tiers) - 1} links, got "
                f"{len(self.links)}")

    @property
    def num_tiers(self) -> int:
        return len(self.tiers)

    def with_link_bandwidths(
            self, bandwidths: "tuple[float | None, ...]"
    ) -> "ChainHardware":
        """The same chain under per-hop effective bandwidths (bytes/s);
        ``None`` entries keep that hop's nominal bandwidth.  The runtime
        re-pick path evaluates the cached Pareto front against this."""
        if len(bandwidths) != len(self.links):
            raise ValueError(
                f"need {len(self.links)} per-hop bandwidths, got "
                f"{len(bandwidths)}")
        links = []
        for link, bw in zip(self.links, bandwidths):
            if bw is None:
                links.append(link)
                continue
            if bw <= 0:
                raise ValueError(
                    f"bandwidth must be positive, got {bw} for {link.name}")
            links.append(dataclasses.replace(link, bandwidth=float(bw)))
        return dataclasses.replace(self, links=tuple(links))


def chain_of(hw: TwoTierHardware) -> ChainHardware:
    """The K=2 chain view of a two-tier environment (same tiers, same
    link, same download payload) -- the paper case as a degenerate
    chain instead of a separate code path."""
    return ChainHardware(tiers=(hw.client, hw.server), links=(hw.link,),
                         download_bytes=hw.download_bytes)


@dataclasses.dataclass
class NetworkState:
    """Mutable runtime view of a link (deliberately NOT frozen).

    Every planning-side profile above is immutable; what *changes* at run
    time is the network.  ``NetworkState`` carries the current effective
    bandwidth estimate (fed by the runtime's EWMA link estimator) next to
    the nominal ``LinkProfile`` the plan assumed, so degradation is always
    a ratio against the planning assumption."""

    base: LinkProfile
    effective_bandwidth: float = 0.0   # bytes/s; 0 -> base.bandwidth
    outage: bool = False               # link currently unusable

    def __post_init__(self):
        if self.effective_bandwidth <= 0.0:
            self.effective_bandwidth = self.base.bandwidth

    @property
    def degradation(self) -> float:
        """planned/effective bandwidth: 1 = nominal, >1 = degraded --
        exactly the ratio ``topsis.link_weights`` consumes."""
        return self.base.bandwidth / self.effective_bandwidth

    def update(self, bandwidth: float, outage: bool = False) -> None:
        if bandwidth > 0:
            self.effective_bandwidth = float(bandwidth)
        self.outage = outage

    def effective_link(self) -> LinkProfile:
        """The nominal profile rebased on the current estimate."""
        return dataclasses.replace(self.base,
                                   bandwidth=self.effective_bandwidth)


# ---------------------------------------------------------------------------
# Paper-faithful profiles (Section III / VI of the paper).
# ---------------------------------------------------------------------------
# Huang et al. LTE/Wi-Fi radio constants quoted by the paper.
ALPHA_U = 283.17    # mW / Mbps
ALPHA_D = 137.01    # mW / Mbps
BETA = 132.86       # mW
PAPER_K = 1.172     # fitted client power constant (paper Section III-C1)

SAMSUNG_J6 = DeviceTier(
    name="samsung-galaxy-j6",
    cores=8, speed_hz=1.6e9,              # Exynos 7870, octa 1.6 GHz
    memory_budget=4 * 1024**3,            # 4 GB RAM
    energy_k=PAPER_K,
)
REDMI_NOTE8 = DeviceTier(
    name="redmi-note-8",
    cores=8, speed_hz=2.0e9,              # SDM665: 4x2.0 + 4x1.8; use 2.0
    memory_budget=4 * 1024**3,
    energy_k=PAPER_K,
)
PAPER_CLOUD = DeviceTier(
    name="paper-cloud-i5",
    cores=4, speed_hz=1.6e9,              # 1.6 GHz quad i5, 8 GB RAM
    memory_budget=8 * 1024**3,
    energy_k=0.0,                         # server energy not billed (Eq. 13)
)
WIFI_10MBPS = LinkProfile(
    name="wifi-10mbps",
    bandwidth=10e6 / 8,                   # 10 Mbps -> bytes/s
    alpha_up_mw_per_mbps=ALPHA_U,
    alpha_down_mw_per_mbps=ALPHA_D,
    beta_mw=BETA,
)

PAPER_ENV_J6 = TwoTierHardware(client=SAMSUNG_J6, server=PAPER_CLOUD,
                               link=WIFI_10MBPS)
PAPER_ENV_NOTE8 = TwoTierHardware(client=REDMI_NOTE8, server=PAPER_CLOUD,
                                  link=WIFI_10MBPS)


# ---------------------------------------------------------------------------
# H100 pod tiers (beyond-paper adaptation).
# ---------------------------------------------------------------------------
def h100_pod_tier(name: str, chips: int, dtype: str = "fp32") -> DeviceTier:
    """A pod of ``chips`` H100s computing in ``dtype`` ("fp32" on the
    CUDA cores, "bf16" on the tensor cores): its peak and pJ/FLOP are
    the dtype's, its memory budget every card's HBM."""
    return DeviceTier(
        name=name, cores=chips, speed_hz=0.0,
        memory_budget=chips * H100_HBM_BYTES,
        chips=chips, peak_flops=chips * H100_PEAK_FLOPS[dtype],
        hbm_bw=chips * H100_HBM_BW,
        pj_per_flop=H100_PJ_PER_FLOP[dtype],
        pj_per_hbm_byte=H100_PJ_PER_HBM_BYTE,
    )


IB_NDR_LINK = LinkProfile(name="inter-pod-ib-ndr", bandwidth=IB_NDR_BW,
                          pj_per_byte=IB_PJ_PER_BYTE_ESTIMATE)


def h100_edge_cloud(dtype: str = "fp32") -> TwoTierHardware:
    """A small "edge" pod of 16 H100s fronting a "cloud" pod of 256 over
    the inter-pod link -- the pod analogue of phone + server."""
    return TwoTierHardware(
        client=h100_pod_tier("h100-edge-16", chips=16, dtype=dtype),
        server=h100_pod_tier("h100-cloud-256", chips=256, dtype=dtype),
        link=IB_NDR_LINK,
    )


H100_EDGE_CLOUD = h100_edge_cloud()
# Two symmetric pods of 256 H100s over the inter-pod link.
H100_TWO_POD = TwoTierHardware(
    client=h100_pod_tier("h100-pod0-256", chips=256),
    server=h100_pod_tier("h100-pod1-256", chips=256),
    link=IB_NDR_LINK,
)

PROFILES = {
    "paper-j6": PAPER_ENV_J6,
    "paper-note8": PAPER_ENV_NOTE8,
    "h100-edge-cloud": H100_EDGE_CLOUD,
    "h100-two-pod": H100_TWO_POD,
}


# ---------------------------------------------------------------------------
# N-tier chain profiles (device -> edge -> regional -> core).
# ---------------------------------------------------------------------------
# Intermediate tiers reuse the paper's cores*speed compute model with
# grid-powered servers (energy_k = 0: only the device's battery is billed,
# matching the paper's Eq. 13 server exemption).
PAPER_EDGE = DeviceTier(
    name="paper-edge-server",
    cores=8, speed_hz=2.5e9,
    memory_budget=16 * 1024**3,
    energy_k=0.0,
)
PAPER_REGIONAL = DeviceTier(
    name="paper-regional-dc",
    cores=16, speed_hz=3.0e9,
    memory_budget=32 * 1024**3,
    energy_k=0.0,
)
PAPER_CORE = DeviceTier(
    name="paper-core-dc",
    cores=32, speed_hz=3.0e9,
    memory_budget=64 * 1024**3,
    energy_k=0.0,
)
# Wired backhaul links: no radio power model (the device's Wi-Fi hop is
# the only one drawing battery), bandwidth rises toward the core.
ETH_100MBPS = LinkProfile(name="ethernet-100mbps", bandwidth=100e6 / 8)
ETH_1GBPS = LinkProfile(name="ethernet-1gbps", bandwidth=1e9 / 8)


GALAXY_S21 = DeviceTier(
    name="samsung-galaxy-s21",
    cores=8, speed_hz=2.9e9,              # Exynos 2100: 1x2.9 prime core
    memory_budget=8 * 1024**3,
    energy_k=PAPER_K,
)

# Device-tier registry: the phone classes a deployment plans for
# (flagship / mid-range / low-end) -- ``serve.py`` and the failover
# tests key tiers by these names.
DEVICE_TIERS: dict[str, DeviceTier] = {
    "flagship": GALAXY_S21,
    "mid": REDMI_NOTE8,
    "low": SAMSUNG_J6,
}

# ---------------------------------------------------------------------------
# Standby tiers (tier-failover targets).
# ---------------------------------------------------------------------------
# Each serving-side tier has a warm standby with *slightly different*
# specs (the spare box in the next rack is rarely identical), so a
# failed-over chain has a genuinely different Pareto front -- which is
# why ``core.smartsplit.cached_chain_plan`` memoises fronts per chain
# and the runtime prewarms the standby fronts at construction.  Phones
# have no standby: the device tier is the user's hand.
PAPER_EDGE_STANDBY = DeviceTier(
    name="paper-edge-standby",
    cores=6, speed_hz=2.2e9,
    memory_budget=12 * 1024**3,
    energy_k=0.0,
)
PAPER_REGIONAL_STANDBY = DeviceTier(
    name="paper-regional-standby",
    cores=12, speed_hz=2.8e9,
    memory_budget=24 * 1024**3,
    energy_k=0.0,
)
PAPER_CORE_STANDBY = DeviceTier(
    name="paper-core-standby",
    cores=24, speed_hz=3.2e9,
    memory_budget=48 * 1024**3,
    energy_k=0.0,
)
PAPER_CLOUD_STANDBY = DeviceTier(
    name="paper-cloud-standby",
    cores=4, speed_hz=2.0e9,
    memory_budget=8 * 1024**3,
    energy_k=0.0,
)

STANDBY_TIERS: dict[str, DeviceTier] = {
    PAPER_EDGE.name: PAPER_EDGE_STANDBY,
    PAPER_REGIONAL.name: PAPER_REGIONAL_STANDBY,
    PAPER_CORE.name: PAPER_CORE_STANDBY,
    PAPER_CLOUD.name: PAPER_CLOUD_STANDBY,
}


def standby_for(tier: DeviceTier) -> DeviceTier | None:
    """The warm standby for ``tier``, or None (device tiers, standbys
    themselves, and anything unregistered have no failover target)."""
    return STANDBY_TIERS.get(tier.name)


def standby_chain(hw: ChainHardware, tier_idx: int) -> ChainHardware | None:
    """``hw`` with tier ``tier_idx`` replaced by its standby (same links,
    same download payload), or None when that tier has no standby."""
    spare = standby_for(hw.tiers[tier_idx])
    if spare is None:
        return None
    tiers = list(hw.tiers)
    tiers[tier_idx] = spare
    return dataclasses.replace(hw, tiers=tuple(tiers))


def paper_chain(num_tiers: int) -> ChainHardware:
    """The paper smartphone fronting a K-tier serving chain.

    K=2 is exactly ``chain_of(PAPER_ENV_J6)``; K=3 adds an edge server
    behind the Wi-Fi hop; K=4 inserts a regional DC between edge and
    core (the arxiv 2509.06049 device/edge/core topology)."""
    if num_tiers == 2:
        return chain_of(PAPER_ENV_J6)
    if num_tiers == 3:
        return ChainHardware(tiers=(SAMSUNG_J6, PAPER_EDGE, PAPER_CORE),
                             links=(WIFI_10MBPS, ETH_100MBPS))
    if num_tiers == 4:
        return ChainHardware(
            tiers=(SAMSUNG_J6, PAPER_EDGE, PAPER_REGIONAL, PAPER_CORE),
            links=(WIFI_10MBPS, ETH_100MBPS, ETH_1GBPS))
    raise ValueError(f"paper_chain supports 2-4 tiers, got {num_tiers}")
