"""Architecture configuration schema for the model zoo (port of
``repro.configs.base``, copied as data).

One ``ArchConfig`` describes any member of the assigned pool: dense GQA,
MLA, MoE, SSM (Mamba-2 SSD), hybrid (Jamba-style interleave), encoder-decoder
(Whisper backbone) and VLM (cross-attention layers). The decoder is built
from a repeating *pattern* of ``LayerSpec``s (pattern length × repeats =
n_layers), which is what lets scan-over-layers keep compile time bounded.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["LayerSpec", "EncoderConfig", "ArchConfig", "reduced"]

LayerKind = Literal["attn", "mamba"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: LayerKind = "attn"
    moe: bool = False          # MoE FFN instead of dense FFN
    cross_attn: bool = False   # cross-attention sublayer (enc-dec / VLM)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Transformer encoder consuming stub frontend embeddings.

    The modality frontend (mel+conv for audio, ViT for vision) is a STUB per
    the assignment: ``input_specs`` provides (batch, enc_seq, d_model)
    embeddings directly.
    """

    n_layers: int
    enc_seq: int              # 1500 audio frames / 1600 image patches
    causal: bool = False


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    head_dim: int | None = None          # default d_model // n_heads

    # attention
    rope_theta: float = 10_000.0
    window: int | None = None            # native sliding-window (SWA) size
    long_context_window: int = 8192      # SWA fallback used for long_500k
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # MLA (deepseek-v2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    mla_absorb: bool = False             # latent-space decode (optimized)
    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_kernel: int = 4
    # encoder / cross-attention
    encoder: EncoderConfig | None = None
    input_mode: Literal["tokens", "tokens+encoder"] = "tokens"
    # misc
    norm_eps: float = 1e-5
    act: Literal["swiglu", "gelu"] = "swiglu"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 4096       # 256 lanes x 16-way model axis
    remat: bool = True                   # activation checkpoint each block
    use_pallas: bool = False             # TPU path (CPU uses pure-jnp oracle)
    source: str = ""                     # citation for the config numbers

    def __post_init__(self):
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not a multiple of "
                f"pattern length {len(self.pattern)}"
            )

    # ---- derived ----
    @property
    def repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def n_params_dense_equivalent(self) -> int:
        """Rough total parameter count (for roofline MODEL_FLOPS = 6·N·D)."""
        return param_count(self)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    """Parameter count from the config (validated vs actual init in tests)."""
    d = cfg.d_model
    total = cfg.padded_vocab * d  # embedding
    if not cfg.tie_embeddings:
        total += cfg.padded_vocab * d
    for spec in cfg.pattern:
        n = cfg.repeats
        if spec.kind == "attn":
            if cfg.is_mla:
                q_in = cfg.q_lora_rank if cfg.q_lora_rank else d
                per = d * cfg.qk_rope_dim + d * cfg.kv_lora_rank
                if cfg.q_lora_rank:
                    per += d * cfg.q_lora_rank
                per += q_in * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
                per += cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
                per += cfg.n_heads * cfg.v_head_dim * d
            else:
                per = d * cfg.hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
                per += cfg.n_heads * cfg.hd * d
        else:  # mamba
            di, G, N, H = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
            per = d * (2 * di + 2 * G * N + H)  # in_proj
            per += cfg.conv_kernel * (di + 2 * G * N)  # depthwise conv
            per += 2 * H + di  # A_log, D, norm
            per += di * d  # out_proj
        if spec.cross_attn:
            per += d * cfg.hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * cfg.hd * d
        # FFN
        mult = 3 if cfg.act == "swiglu" else 2
        if spec.moe:
            per += d * cfg.n_experts  # router
            per += cfg.n_experts * mult * d * cfg.d_ff if not active_only else (
                cfg.top_k * mult * d * cfg.d_ff)
            per += cfg.n_shared_experts * mult * d * cfg.d_ff
        elif cfg.d_ff > 0:
            per += mult * d * cfg.d_ff
        per += 3 * d  # norms
        total += per * n
    if cfg.encoder is not None:
        mult = 3 if cfg.act == "swiglu" else 2
        per = d * cfg.hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * cfg.hd * d
        per += mult * d * cfg.d_ff + 2 * d
        total += per * cfg.encoder.n_layers
    return int(total)


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Reduced same-family variant for CPU smoke tests (assignment: <=2
    layers-ish, d_model <= 512, <= 4 experts)."""
    pat = cfg.pattern
    kw = dict(
        n_layers=len(pat),
        d_model=256,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 2,
        head_dim=64,
        d_ff=512 if cfg.d_ff else 0,
        vocab_size=512,
        vocab_pad_multiple=128,
        window=min(cfg.window, 64) if cfg.window else None,
        long_context_window=64,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        # drop-free capacity so decode (tiny token counts) == forward in the
        # smoke equivalence tests; prod configs keep their own factor
        capacity_factor=float(max(min(cfg.n_experts, 4), 1)) if cfg.n_experts else 1.25,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        kv_lora_rank=64 if cfg.kv_lora_rank else 0,
        q_lora_rank=0,
        qk_nope_dim=32 if cfg.is_mla else cfg.qk_nope_dim,
        qk_rope_dim=16 if cfg.is_mla else cfg.qk_rope_dim,
        v_head_dim=32 if cfg.is_mla else cfg.v_head_dim,
        ssm_state=min(cfg.ssm_state, 32) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else cfg.ssm_head_dim,
        ssm_chunk=16,
        encoder=(
            EncoderConfig(n_layers=1, enc_seq=16, causal=cfg.encoder.causal)
            if cfg.encoder else None
        ),
        dtype="float32",
        remat=False,
        name=cfg.name + "-smoke",
    )
    kw.update(overrides)
    return cfg.replace(**kw)
