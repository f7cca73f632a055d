"""Architecture configs: the schema every assigned architecture fills in,
plus the analytic per-block cost methods the SmartSplit profiler uses and
the ShapeDtypeStruct input specs the dry-run lowers against.

Block kinds:
  attn_mlp   -- GQA attention + dense (SwiGLU) MLP         (dense archs)
  attn_moe   -- GQA attention + top-k MoE                   (MoE archs)
  rwkv       -- RWKV6 time-mix + channel-mix                (attn-free)
  mamba      -- Mamba2 block                                (SSM)
  mamba_attn -- Mamba2 block + zamba2 shared attention+MLP  (hybrid)
  enc_attn   -- bidirectional attention + MLP               (encoder-only)
"""
from __future__ import annotations

import dataclasses

VOCAB_PAD_MULTIPLE = 2048  # lcm-friendly with a 16-way model axis


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str            # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str              # dense / moe / ssm / hybrid / audio / vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                   # dense MLP hidden (or attn-block MLP hidden)
    vocab_size: int
    head_dim: int = 0           # 0 => d_model // num_heads
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0           # per-expert hidden (0 => d_ff)
    moe_capacity_factor: float = 1.25
    # SSM / RWKV
    ssm_state: int = 0
    ssm_heads: int = 0          # mamba2 value heads (0 => 2*d_model // 64)
    ssm_groups: int = 8         # mamba2 B/C groups (GQA-style)
    ssm_expand: int = 2
    # layer pattern
    pattern: str = "attn_mlp"   # attn_mlp | attn_moe | rwkv | mamba | enc_attn
    attn_every: int = 0         # zamba2: shared attn after every k mamba
    # attention details
    qk_norm: bool = False
    sliding_window: int = 0     # 0 = full causal attention
    rope_theta: float = 1e4
    is_encoder: bool = False
    frontend: str = "none"      # none | audio | vision (stub embeddings)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    source: str = ""            # citation for the config numbers
    # Activation-checkpoint policy for train_step: "none" | "block"
    remat: str = "block"

    # ------------------------------------------------------------------
    def __post_init__(self):
        assert self.d_model % 2 == 0
        if self.pattern in ("attn_mlp", "attn_moe", "enc_attn"):
            assert self.num_heads > 0 and self.num_kv_heads > 0
            assert self.num_heads % self.num_kv_heads == 0

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        m = VOCAB_PAD_MULTIPLE
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def e_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def n_mamba_heads(self) -> int:
        return self.ssm_heads or max(1, (self.ssm_expand * self.d_model) // 64)

    # ------------------------------------------------------------------
    def block_kinds(self) -> list[str]:
        if self.pattern == "mamba" and self.attn_every:
            return ["mamba_attn" if (i + 1) % self.attn_every == 0
                    else "mamba" for i in range(self.num_layers)]
        return [self.pattern] * self.num_layers

    # -- parameter counts (per block, in parameter *elements*) ----------
    def _attn_params(self) -> float:
        d, h, kv, hd = self.d_model, self.num_heads, self.num_kv_heads, self.hd
        return d * h * hd + 2 * d * kv * hd + h * hd * d \
            + (2 * hd if self.qk_norm else 0) + 2 * d  # norms

    def _mlp_params(self, ff: int) -> float:
        return 3 * self.d_model * ff  # SwiGLU: gate, up, down

    def _moe_params(self) -> float:
        return self.num_experts * self._mlp_params(self.e_ff) \
            + self.d_model * self.num_experts  # router

    def _mamba_params(self) -> float:
        d = self.d_model
        inner = self.ssm_expand * d
        nh = self.n_mamba_heads
        # in_proj: x -> (z, x, B, C, dt); B/C are per-GROUP (Mamba2's
        # GQA-style sharing), dt per head; out_proj: inner -> d.
        bc = 2 * self.ssm_state * self.ssm_groups
        return d * (2 * inner + bc + nh) + inner * d + 2 * d

    def _rwkv_params(self) -> float:
        d = self.d_model
        # time-mix: r,k,v,w,g projections + output; channel-mix: 2 mats
        tm = 5 * d * d + d * d
        cm = d * self.d_ff + self.d_ff * d
        return tm + cm + 4 * d

    def block_params(self, kind: str) -> float:
        if kind in ("attn_mlp", "enc_attn"):
            return self._attn_params() + self._mlp_params(self.d_ff)
        if kind == "attn_moe":
            return self._attn_params() + self._moe_params()
        if kind == "mamba":
            return self._mamba_params()
        if kind == "mamba_attn":
            # shared attn+MLP params are charged once in the profile of the
            # first mamba_attn block; duplication-on-split is handled by the
            # planner's state accounting.  Here: amortised share.
            n_attn = max(1, sum(k == "mamba_attn" for k in self.block_kinds()))
            shared = self._attn_params() + self._mlp_params(self.d_ff)
            return self._mamba_params() + shared / n_attn
        if kind == "rwkv":
            return self._rwkv_params()
        raise ValueError(kind)

    def total_params(self) -> float:
        blocks = sum(self.block_params(k) for k in self.block_kinds())
        embed = self.padded_vocab * self.d_model
        unembed = 0 if self.tie_embeddings else self.padded_vocab * self.d_model
        return blocks + embed + unembed

    def active_params(self) -> float:
        """Parameters touched per token (MoE: top-k experts only)."""
        total = self.padded_vocab * self.d_model * \
            (1 if self.tie_embeddings else 2)
        for k in self.block_kinds():
            if k == "attn_moe":
                total += self._attn_params() \
                    + self.experts_per_token * self._mlp_params(self.e_ff) \
                    + self.d_model * self.num_experts
            else:
                total += self.block_params(k)
        return total

    # -- FLOPs per block for a given workload ---------------------------
    def block_flops(self, kind: str, *, seq_len: int, batch: int,
                    mode: str) -> float:
        """Forward FLOPs (multiply-adds x2). mode: prefill|decode|train;
        train = 3x forward (fwd + 2x bwd)."""
        q_tokens = batch * (1 if mode == "decode" else seq_len)
        kv_len = seq_len
        if self.sliding_window and mode == "decode":
            kv_len = min(seq_len, self.sliding_window)
        d, hd = self.d_model, self.hd
        h, kv = self.num_heads, self.num_kv_heads

        def attn_flops(causal: bool) -> float:
            proj = 2 * q_tokens * d * (h * hd + 2 * kv * hd + h * hd)
            if mode == "decode":
                av = 2 * q_tokens * h * hd * kv_len * 2
            else:
                ctx = kv_len if not causal else kv_len / 2
                if self.sliding_window:
                    ctx = min(ctx, self.sliding_window)
                av = 2 * q_tokens * h * hd * ctx * 2
            return proj + av

        def mlp_flops(ff: int, per_tok: int = 1) -> float:
            return 2 * q_tokens * d * ff * 3 * per_tok

        if kind in ("attn_mlp", "enc_attn"):
            f = attn_flops(causal=not self.is_encoder) + mlp_flops(self.d_ff)
        elif kind == "attn_moe":
            f = attn_flops(True) + mlp_flops(self.e_ff,
                                             self.experts_per_token) \
                + 2 * q_tokens * d * self.num_experts
        elif kind in ("mamba", "mamba_attn"):
            inner = self.ssm_expand * d
            nh, ds = self.n_mamba_heads, self.ssm_state
            proj = 2 * q_tokens * d * (2 * inner + 2 * self.ssm_groups * ds
                                       + nh) + 2 * q_tokens * inner * d
            scan = 2 * q_tokens * inner * ds * 3
            f = proj + scan
            if kind == "mamba_attn":
                f += attn_flops(True) + mlp_flops(self.d_ff)
        elif kind == "rwkv":
            tm = 2 * q_tokens * d * d * 6
            wkv = 2 * q_tokens * d * 64 * 3   # per-head hd=64 state update
            cm = 2 * q_tokens * d * self.d_ff * 2
            f = tm + wkv + cm
        else:
            raise ValueError(kind)
        return 3 * f if mode == "train" else f

    def block_state_bytes(self, kind: str, *, batch: int,
                          dtype_bytes: int = 2) -> float:
        """Recurrent state that must migrate if the split cuts here."""
        if kind in ("mamba", "mamba_attn"):
            nh, ds = self.n_mamba_heads, self.ssm_state
            inner = self.ssm_expand * self.d_model
            return batch * (inner // max(nh, 1)) * nh * ds * dtype_bytes
        if kind == "rwkv":
            nh = self.d_model // 64
            return batch * nh * 64 * 64 * dtype_bytes
        return 0.0

    def model_flops(self, *, seq_len: int, batch: int, mode: str) -> float:
        """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for train;
        2*N*D for inference -- the roofline's useful-work numerator."""
        tokens = batch * (1 if mode == "decode" else seq_len)
        mult = 6 if mode == "train" else 2
        return mult * self.active_params() * tokens

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family, toy size."""
        return dataclasses.replace(
            self, name=self.name + "-smoke", num_layers=2,
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=64 if self.head_dim else 0,
            d_ff=min(self.d_ff, 512),
            moe_d_ff=min(self.e_ff, 256) if self.num_experts else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.num_experts else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=4 if self.pattern == "mamba" else 0,
            ssm_groups=2,
            attn_every=2 if self.attn_every else 0,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0,
        )


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (loads all config modules)
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    import repro_torch.configs  # noqa: F401
    return dict(_REGISTRY)


def shape_skips(cfg: ModelConfig, shape: InputShape) -> str | None:
    """Return a skip reason, or None if the (arch, shape) cell runs."""
    if cfg.is_encoder and shape.mode == "decode":
        return "encoder-only: no autoregressive decode"
    return None
