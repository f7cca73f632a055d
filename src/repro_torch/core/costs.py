"""Latency / energy / memory cost models (paper Section III).

The unit the optimiser reasons over is a ``LayerProfile``: one entry per
splittable layer with its work (FLOPs), memory traffic, resident memory, and
the size of the activation that would cross the client->server boundary if
the model were split *after* this layer.  Profiles are produced analytically
by ``models/profiles.py`` (for both the paper's CNNs and the assigned
transformer architectures) and cross-checked against compiled-HLO
``cost_analysis`` in tests.

Cost model semantics (paper Eq. 2-13):

  T_client  = M_client|l1 / (C_client * S_client)               (Eq. 2)
  T_server  = M_server|l2 / (C_server * S_server)               (Eq. 3)
  T_upload  = I|l1 / B                                          (Eq. 4)
  E_client  = (k * C * nu^3) * T_client                         (Eq. 7)
  E_upload  = (alpha_u * tau_u + beta_u) * T_upload             (Eq. 9)
  E_download= (alpha_d * tau_d + beta_d) * (d / B)              (Eq. 12)

For roofline (pod) tiers the compute time per side is
``max(flops/peak, bytes/hbm_bw)`` summed over that side's layers, and the
energy is per-op accounting (pJ/FLOP + pJ/byte + pJ/link-byte); everything
else is identical in form.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dtype_policy import (conv_dtype, dtype_bytes,
                                     resolve_wire_dtype,
                                     wire_payload_bytes_per_elem)
from repro_torch.core.hardware import ChainHardware, DeviceTier, TwoTierHardware

# Per-transfer framing overhead (crc32 + length) the reliable transfer
# layer adds to every wire attempt -- runtime/transfer.py aliases this, so
# the pipeline cost model and the executor charge the same bytes.
FRAME_HEADER_BYTES = 8

# Multipart framing an int8 boundary adds inside the payload: a part-count
# word plus a (length, crc32) header per part -- (scales, data) is two
# parts.  runtime/transfer.py's pack_frames aliases these too.
PART_HEADER_BYTES = 8
MULTIPART_BASE_BYTES = 4
INT8_FRAME_OVERHEAD_BYTES = MULTIPART_BASE_BYTES + 2 * PART_HEADER_BYTES

# One fp32 absmax scale accompanies each quantization channel.
WIRE_SCALE_BYTES = 4

# ``hw.download_bytes`` is calibrated as an fp32-sized result payload
# (paper Eq. 11's fixed d); the wire policy rescales its element bytes.
DOWNLOAD_BASE_ELEM_BYTES = 4.0

# Codec compute surcharge, in passes over the boundary tensor's storage
# bytes: int8 quantize = absmax reduce + scale/round (fused kernel, but the
# tensor is still read twice conceptually), dequantize = one pass; a plain
# float cast = one pass each side.  Charged on the sending/receiving tier
# so the optimiser sees that re-encoding is not free.
QUANT_ENCODE_PASSES = 2.0
QUANT_DECODE_PASSES = 1.0
CAST_PASSES = 1.0


@dataclasses.dataclass(frozen=True)
class LayerProfile:
    """Per-layer costs, all in base units (FLOPs, bytes)."""

    name: str
    kind: str                   # conv / fc / pool / act / norm / attn / moe ...
    flops: float                # useful FLOPs for one inference of this layer
    param_bytes: float          # resident weight bytes
    act_bytes: float            # output activation bytes (workspace)
    boundary_bytes: float       # bytes crossing the link if split AFTER this
    # Extra payload that must accompany a split after this layer (e.g. SSM /
    # WKV recurrent state for the remaining layers, paper-CNN: 0).
    state_bytes: float = 0.0
    # Quantization groups of the boundary tensor (channel count for feature
    # maps, 1 for flat activations; 0 = unknown, treated as 1) -- prices the
    # per-channel fp32 scales an int8 wire format ships.
    boundary_channels: float = 0.0

    @property
    def mem_bytes(self) -> float:
        """Paper's M|layer: memory utilised running this layer (weights +
        output tensor) -- the learnopencv counting the paper cites."""
        return self.param_bytes + self.act_bytes


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """A splittable model: ordered layers + input size.

    ``dtype`` records the storage policy every byte term was computed
    under (fp32 | bf16).  The latency/energy/memory models below consume
    bytes, so they are dtype-aware through the profile: a bf16 profile's
    memory and transfer terms are half its fp32 twin's, and the optimiser
    can pick splits that only fit the client budget at bf16."""

    name: str
    layers: tuple[LayerProfile, ...]
    input_bytes: float          # payload if split at l1 = 0 (COC)
    dtype: str = "fp32"         # storage policy the byte terms assume
    # Whether the l1=0 input upload is stored under the policy too.  True
    # for the CNNs (the client casts the image like any activation);
    # False when the input is policy-independent (int32 token ids).
    input_follows_dtype: bool = True
    # Quantization groups of the l1=0 input upload (image channels).
    input_channels: float = 0.0

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def with_dtype(self, dtype: str) -> "ModelProfile":
        """The same model re-profiled under another storage policy: every
        byte term (weights, activations, boundary payloads, migrating
        state, and -- unless ``input_follows_dtype`` is off -- the input
        upload) rescales by the element-size ratio; FLOPs are unchanged
        (the fp32 accumulator does the same arithmetic)."""
        policy = conv_dtype(dtype)
        ratio = dtype_bytes(policy) / dtype_bytes(self.dtype)
        if ratio == 1.0:
            return dataclasses.replace(self, dtype=policy)
        layers = tuple(dataclasses.replace(
            l, param_bytes=l.param_bytes * ratio,
            act_bytes=l.act_bytes * ratio,
            boundary_bytes=l.boundary_bytes * ratio,
            state_bytes=l.state_bytes * ratio) for l in self.layers)
        in_b = self.input_bytes * ratio if self.input_follows_dtype \
            else self.input_bytes
        return dataclasses.replace(self, layers=layers, input_bytes=in_b,
                                   dtype=policy)

    # -- cumulative views (vectorised; the GA evaluates whole populations) --
    def cum_mem(self) -> np.ndarray:
        """cum_mem[i] = M|l1 for l1 = i  (memory of first i layers)."""
        m = np.array([l.mem_bytes for l in self.layers])
        return np.concatenate([[0.0], np.cumsum(m)])

    def cum_flops(self) -> np.ndarray:
        f = np.array([l.flops for l in self.layers])
        return np.concatenate([[0.0], np.cumsum(f)])

    def cum_param_bytes(self) -> np.ndarray:
        p = np.array([l.param_bytes for l in self.layers])
        return np.concatenate([[0.0], np.cumsum(p)])

    def boundary(self) -> np.ndarray:
        """boundary[i] = I|l1 for split index l1 = i (i layers on client).

        boundary[0] = input_bytes (everything on the server);
        boundary[L] = 0 (nothing crosses -- COS)."""
        b = [self.input_bytes]
        for l in self.layers:
            b.append(l.boundary_bytes + l.state_bytes)
        b[-1] = 0.0
        return np.array(b)

    def boundary_groups(self) -> np.ndarray:
        """boundary_groups[i] = quantization channels of boundary ``i``
        (unknown counts fall back to 1 = per-tensor)."""
        g = [self.input_channels or 1.0]
        for l in self.layers:
            g.append(l.boundary_channels or 1.0)
        return np.array(g)

    def wire_boundary(self, wire: str | None = None,
                      hop: int | None = None) -> np.ndarray:
        """boundary() priced in the wire format of one hop.

        ``follow`` (and any wire format equal to the storage dtype) returns
        ``boundary()`` unchanged -- the legacy bytes, exactly.  A float wire
        format rescales element bytes; ``int8`` charges 1 byte/element plus
        the per-channel fp32 scales and the two-part (scales, data) framing
        overhead the transfer layer actually puts on the wire."""
        w = resolve_wire_dtype(wire, storage=self.dtype, hop=hop)
        b = self.boundary()
        if w == self.dtype:
            return b
        elems = b / dtype_bytes(self.dtype)
        if w != "int8":
            return elems * wire_payload_bytes_per_elem(w)
        wb = (elems + WIRE_SCALE_BYTES * self.boundary_groups()
              + INT8_FRAME_OVERHEAD_BYTES)
        return np.where(elems > 0, wb, 0.0)


# ---------------------------------------------------------------------------
# Latency model
# ---------------------------------------------------------------------------
def _tier_compute_time(tier: DeviceTier, mem_bytes, flops, hbm_bytes):
    """Compute time on one tier for (vectorised) cumulative work.

    Paper tiers: Eq. 2/3 -- memory-as-work over cores*speed.
    Roofline tiers: max(flops/peak, bytes/bw).
    """
    if tier.is_roofline:
        return np.maximum(flops / tier.peak_flops, hbm_bytes / tier.hbm_bw)
    return mem_bytes / tier.compute_scale


def _codec_passes(wire: str, storage: str) -> tuple[float, float]:
    """(encode, decode) passes over the boundary tensor for one hop."""
    if wire == storage:
        return 0.0, 0.0
    if wire == "int8":
        return QUANT_ENCODE_PASSES, QUANT_DECODE_PASSES
    return CAST_PASSES, CAST_PASSES


def _codec_time(tier: DeviceTier, touched_bytes):
    """Seconds one tier spends re-encoding ``touched_bytes`` of boundary."""
    if tier.is_roofline:
        return touched_bytes / tier.hbm_bw
    return touched_bytes / tier.compute_scale


def download_wire_bytes(download_bytes: float, wire: str) -> float:
    """The fixed result payload priced in the wire format (satellite fix:
    a bf16/int8 plan no longer charges an fp32-sized download)."""
    if wire == "fp32":
        return float(download_bytes)
    elems = download_bytes / DOWNLOAD_BASE_ELEM_BYTES
    if wire == "int8":
        # per-tensor quantized result vector: one scale, two-part framing
        return elems + WIRE_SCALE_BYTES + INT8_FRAME_OVERHEAD_BYTES
    return elems * wire_payload_bytes_per_elem(wire)


def latency_terms(profile: ModelProfile, hw: TwoTierHardware,
                  wire: str | None = None):
    """Return (T_client, T_upload, T_server, T_download) arrays indexed by
    split index l1 = 0..L (l1 layers on the client).

    ``wire`` is the hop's wire-dtype policy (default: env resolution;
    ``follow`` prices the storage bytes, unchanged).  A re-encoding wire
    format also bills the quantize/dequantize passes on each tier."""
    cm = profile.cum_mem()
    cf = profile.cum_flops()
    # HBM traffic proxy: weights + activations each touched once.
    ch = cm
    t_client = _tier_compute_time(hw.client, cm, cf, ch)
    t_server = _tier_compute_time(hw.server, cm[-1] - cm, cf[-1] - cf,
                                  ch[-1] - ch)
    w = resolve_wire_dtype(wire, storage=profile.dtype, hop=0)
    t_upload = profile.wire_boundary(w) / hw.link.bandwidth
    enc_p, dec_p = _codec_passes(w, profile.dtype)
    if enc_p:
        bound = profile.boundary()
        t_client = t_client + _codec_time(hw.client, enc_p * bound)
        t_server = t_server + _codec_time(hw.server, dec_p * bound)
    d_bytes = download_wire_bytes(hw.download_bytes, w)
    t_download = np.full_like(t_upload, d_bytes / hw.link.bandwidth)
    # COS (l1 = L): no server interaction at all.
    t_download[-1] = 0.0
    # COC (l1 = 0): client does nothing.
    return t_client, t_upload, t_server, t_download


def total_latency(profile: ModelProfile, hw: TwoTierHardware,
                  wire: str | None = None) -> np.ndarray:
    """Paper Eq. 5 (download latency measured negligible, excluded)."""
    t_c, t_u, t_s, _ = latency_terms(profile, hw, wire)
    return t_c + t_u + t_s


# ---------------------------------------------------------------------------
# Energy model (client-side energy only, per the paper)
# ---------------------------------------------------------------------------
def energy_terms(profile: ModelProfile, hw: TwoTierHardware,
                 wire: str | None = None):
    """Return (E_client, E_upload, E_download) arrays indexed by l1."""
    t_c, t_u, _, t_d = latency_terms(profile, hw, wire)
    w = resolve_wire_dtype(wire, storage=profile.dtype, hop=0)
    cf = profile.cum_flops()
    cm = profile.cum_mem()
    if hw.client.is_roofline:
        e_client = (cf * hw.client.pj_per_flop
                    + cm * hw.client.pj_per_hbm_byte) * 1e-12
        e_link_up = profile.wire_boundary(w) * hw.link.pj_per_byte * 1e-12
        e_link_down = np.full_like(
            e_link_up,
            download_wire_bytes(hw.download_bytes, w)
            * hw.link.pj_per_byte * 1e-12)
        e_link_down[-1] = 0.0
        return e_client, e_link_up, e_link_down
    # Paper model: throughput tau == link bandwidth while transferring
    # (constraint tau <= B holds with equality under saturation).
    p_client = hw.client.compute_power_w()
    p_up = hw.link.upload_power_w(hw.link.bandwidth)
    p_down = hw.link.download_power_w(hw.link.bandwidth)
    return p_client * t_c, p_up * t_u, p_down * t_d


def total_energy(profile: ModelProfile, hw: TwoTierHardware,
                 wire: str | None = None) -> np.ndarray:
    """Paper Eq. 13."""
    e_c, e_u, e_d = energy_terms(profile, hw, wire)
    return e_c + e_u + e_d


def client_memory(profile: ModelProfile, mode: str = "full") -> np.ndarray:
    """Paper Eq. 16: f3 = M_client | l1.

    mode='full': weights + activations (literal reading of M).
    mode='activations': activation footprint only -- the *table-calibrated*
    variant: reconstructing Table I from the paper's equations leaves the
    composition of M|l1 in f3 under-specified, and the activations-only
    reading reproduces the paper's published splits for AlexNet/VGG13/VGG16
    exactly (see EXPERIMENTS.md 'Calibration')."""
    if mode == "full":
        return profile.cum_mem()
    if mode == "activations":
        a = np.array([l.act_bytes for l in profile.layers])
        return np.concatenate([[0.0], np.cumsum(a)])
    raise ValueError(mode)


def evaluate_objectives(profile: ModelProfile, hw: TwoTierHardware,
                        f3_mode: str = "full",
                        wire: str | None = None) -> np.ndarray:
    """(L+1, 3) matrix of (f1 latency, f2 energy, f3 memory) per split l1."""
    return np.stack([total_latency(profile, hw, wire),
                     total_energy(profile, hw, wire),
                     client_memory(profile, f3_mode)], axis=1)


def feasible_mask(profile: ModelProfile, hw: TwoTierHardware,
                  allow_degenerate: bool = False) -> np.ndarray:
    """Constraints of Eq. 17 over split index l1 = 0..L.

    * M_client|l1 <= memory budget,
    * 1 <= l1 <= L-1 and l2 = L - l1 >= 1 (unless ``allow_degenerate`` for
      the COS/COC baselines),
    * tau <= B holds by construction (we model saturation at B).
    """
    L = profile.num_layers
    mem_ok = profile.cum_mem() <= hw.client.memory_budget
    idx = np.arange(L + 1)
    if allow_degenerate:
        rng_ok = np.ones(L + 1, bool)
    else:
        rng_ok = (idx >= 1) & (idx <= L - 1)
    return mem_ok & rng_ok


# ---------------------------------------------------------------------------
# Chain (K-tier) generalisation with microbatch pipelining
# ---------------------------------------------------------------------------
def _chain_edges(profile: ModelProfile, genomes: np.ndarray) -> np.ndarray:
    """(n, K+1) stage-edge matrix [0 | sorted cuts | L] per genome row."""
    L = profile.num_layers
    cuts = np.sort(np.asarray(genomes, np.int64), axis=1)
    n = cuts.shape[0]
    return np.concatenate([np.zeros((n, 1), np.int64), cuts,
                           np.full((n, 1), L, np.int64)], axis=1)


def resolve_chain_wire(wire, n_hops: int, storage: str) -> tuple[str, ...]:
    """Concrete per-hop wire formats for a K-1-hop chain.

    ``wire`` may be None (env resolution per hop: ``REPRO_LINK{k}_
    WIRE_DTYPE`` over ``REPRO_WIRE_DTYPE`` over ``follow``), one policy
    string for every hop, or a per-hop sequence of policies/None."""
    if wire is None or isinstance(wire, str):
        return tuple(resolve_wire_dtype(wire, storage=storage, hop=k)
                     for k in range(n_hops))
    ws = tuple(wire)
    if len(ws) != n_hops:
        raise ValueError(
            f"per-hop wire needs {n_hops} entries, got {len(ws)}")
    return tuple(resolve_wire_dtype(wk, storage=storage, hop=k)
                 for k, wk in enumerate(ws))


def chain_stage_hop_times(profile: ModelProfile, hw: ChainHardware,
                          genomes: np.ndarray, wire=None
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Per-stage compute and per-hop transfer seconds for cut vectors.

    genomes: (n, K-1) cut points (unsorted ok; sorted internally).
    Returns ``(stage_T, hop_T)`` with shapes (n, K) and (n, K-1) -- the
    whole-batch times the pipeline latency model (and the chain runtime's
    virtual-clock schedule) are built from.  ``wire`` prices each hop in
    its wire format and bills the codec passes on the adjacent tiers."""
    edges = _chain_edges(profile, genomes)
    cf = profile.cum_flops()
    cm = profile.cum_mem()
    bound = profile.boundary()
    ws = resolve_chain_wire(wire, len(hw.links), profile.dtype)
    n, K = edges.shape[0], len(hw.tiers)
    stage_T = np.zeros((n, K))
    for k, tier in enumerate(hw.tiers):
        f_k = cf[edges[:, k + 1]] - cf[edges[:, k]]
        m_k = cm[edges[:, k + 1]] - cm[edges[:, k]]
        stage_T[:, k] = _tier_compute_time(tier, m_k, f_k, m_k)
    hop_T = np.zeros((n, K - 1))
    for k, link in enumerate(hw.links):
        wb = profile.wire_boundary(ws[k])
        hop_T[:, k] = wb[edges[:, k + 1]] / link.bandwidth
        enc_p, dec_p = _codec_passes(ws[k], profile.dtype)
        if enc_p:
            b_k = bound[edges[:, k + 1]]
            stage_T[:, k] += _codec_time(hw.tiers[k], enc_p * b_k)
            stage_T[:, k + 1] += _codec_time(hw.tiers[k + 1], dec_p * b_k)
    return stage_T, hop_T


def pipeline_latency(stage_T: np.ndarray, hop_T: np.ndarray,
                     microbatches: int = 1,
                     link_bandwidths: np.ndarray | None = None
                     ) -> np.ndarray:
    """End-to-end chain latency with M microbatches (GPipe-style).

    Each whole-batch unit time T (stage computes and hop transfers,
    interleaved) becomes M per-microbatch units of T/M; the first
    microbatch fills the pipeline in sum(T)/M and the remaining M-1
    drain behind the slowest unit:

        latency = (sum_i T_i + (M - 1) * max_i T_i) / M

    M=1 reduces exactly to the sequential sum the two-tier paper model
    uses.  ``link_bandwidths`` (per hop, bytes/s) prices the extra
    framing headers the M-way split puts on each hop -- the term that
    keeps the optimiser honest about oversplitting tiny boundaries."""
    if microbatches < 1:
        raise ValueError(
            f"microbatches must be >= 1, got {microbatches}")
    # Interleave [stage0, hop0, stage1, hop1, ..., stageK-1] -- the actual
    # pipeline unit order (and, for K=2 at M=1, the exact t_c + t_u + t_s
    # summation order of the two-tier model).
    n, K = stage_T.shape
    units = np.zeros((n, 2 * K - 1))
    units[:, 0::2] = stage_T
    units[:, 1::2] = hop_T
    total = units.sum(axis=1)
    if microbatches == 1:
        return total
    lat = (total + (microbatches - 1) * units.max(axis=1)) / microbatches
    if link_bandwidths is not None:
        overhead = (microbatches - 1) * FRAME_HEADER_BYTES
        lat = lat + (overhead / np.asarray(link_bandwidths, float)).sum()
    return lat


def chain_feasible_mask(profile: ModelProfile, hw: ChainHardware,
                        genomes: np.ndarray) -> np.ndarray:
    """Chain constraints: every stage non-empty, every tier within its
    memory budget (the K-tier Eq. 17)."""
    edges = _chain_edges(profile, genomes)
    cm = profile.cum_mem()
    ok = (np.diff(edges, axis=1) >= 1).all(axis=1)
    for k, tier in enumerate(hw.tiers):
        m_k = cm[edges[:, k + 1]] - cm[edges[:, k]]
        ok &= m_k <= tier.memory_budget
    return ok


def evaluate_chain_objectives(profile: ModelProfile, hw: ChainHardware,
                              genomes: np.ndarray, f3_mode: str = "full",
                              microbatches: int = 1,
                              wire=None) -> np.ndarray:
    """(n, 3) chain objectives -- the exact K-tier generalisation of
    ``evaluate_objectives``.

    f1: pipeline latency over stage computes + hop uploads (download
        excluded per paper Eq. 5; M=1 degenerates to the sequential sum,
        so a K=2 chain reproduces the two-tier rows bit-for-bit).
    f2: battery-billed energy -- every tier except the terminal one
        (the paper's Eq. 13 server exemption, generalised: the core end
        is grid-powered) plus per-hop transfer energy and the download
        radio term on hop 0 (the device's radio).
    f3: first-tier memory, ``client_memory`` semantics (constraints on
        the other tiers' budgets live in ``chain_feasible_mask``)."""
    edges = _chain_edges(profile, genomes)
    cf = profile.cum_flops()
    cm = profile.cum_mem()
    ws = resolve_chain_wire(wire, len(hw.links), profile.dtype)
    stage_T, hop_T = chain_stage_hop_times(profile, hw, genomes, wire=ws)
    bws = np.array([link.bandwidth for link in hw.links])
    lat = pipeline_latency(stage_T, hop_T, microbatches,
                           link_bandwidths=bws)

    en = np.zeros(edges.shape[0])
    for k, tier in enumerate(hw.tiers[:-1]):
        if tier.is_roofline:
            f_k = cf[edges[:, k + 1]] - cf[edges[:, k]]
            m_k = cm[edges[:, k + 1]] - cm[edges[:, k]]
            en += (f_k * tier.pj_per_flop
                   + m_k * tier.pj_per_hbm_byte) * 1e-12
        else:
            en += tier.compute_power_w() * stage_T[:, k]
    for k, link in enumerate(hw.links):
        b_k = profile.wire_boundary(ws[k])[edges[:, k + 1]]
        if link.pj_per_byte:
            en += b_k * link.pj_per_byte * 1e-12
        else:
            en += link.upload_power_w(link.bandwidth) * hop_T[:, k]
    # result download, charged on the device's hop-0 radio (Eq. 12),
    # priced in hop 0's wire format
    down = hw.links[0]
    d_bytes = download_wire_bytes(hw.download_bytes, ws[0])
    if down.pj_per_byte:
        en += d_bytes * down.pj_per_byte * 1e-12
    else:
        en += down.download_power_w(down.bandwidth) \
            * (d_bytes / down.bandwidth)
    if microbatches > 1:
        extra = (microbatches - 1) * FRAME_HEADER_BYTES
        for k, link in enumerate(hw.links):
            if link.pj_per_byte:
                en += extra * link.pj_per_byte * 1e-12
            else:
                en += link.upload_power_w(link.bandwidth) \
                    * (extra / link.bandwidth)

    mem = client_memory(profile, f3_mode)[edges[:, 1]]
    return np.stack([lat, en, mem], axis=1)


def check_profile(profile: ModelProfile) -> None:
    """Sanity-check invariants every profile must satisfy."""
    assert profile.num_layers >= 2, profile.name
    for l in profile.layers:
        assert l.flops >= 0 and l.param_bytes >= 0 and l.act_bytes >= 0, l
        assert l.boundary_bytes >= 0 and l.state_bytes >= 0, l
    assert profile.input_bytes > 0
