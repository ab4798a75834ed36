"""The 10 assigned architectures (port of ``repro.configs.archs``, copied
as data).

Every config cites its source in ``source``. Reduced smoke variants come
from :func:`repro_torch.configs.base.reduced`. The port initialises the
dense-attention patterns only (``repro_torch.models.transformer.init_lm``
raises for the others).
"""

from __future__ import annotations

from repro_torch.configs import register_arch
from repro_torch.configs.base import ArchConfig, EncoderConfig, LayerSpec

A = LayerSpec(kind="attn")
Am = LayerSpec(kind="attn", moe=True)
Ax = LayerSpec(kind="attn", cross_attn=True)
M = LayerSpec(kind="mamba")
Mm = LayerSpec(kind="mamba", moe=True)


@register_arch("minitron-4b")
def minitron_4b(**kw) -> ArchConfig:
    return ArchConfig(
        name="minitron-4b", n_layers=32, d_model=3072, n_heads=24,
        n_kv_heads=8, head_dim=128, d_ff=9216, vocab_size=256000,
        pattern=(A,), source="pruned nemotron [arXiv:2407.14679]",
    ).replace(**kw)


@register_arch("glm4-9b")
def glm4_9b(**kw) -> ArchConfig:
    return ArchConfig(
        name="glm4-9b", n_layers=40, d_model=4096, n_heads=32,
        n_kv_heads=2, head_dim=128, d_ff=13696, vocab_size=151552,
        pattern=(A,), source="RoPE, GQA [hf:THUDM/glm-4-9b]",
    ).replace(**kw)


@register_arch("jamba-v0.1-52b")
def jamba_52b(**kw) -> ArchConfig:
    # Mamba:attention 7:1 interleave (1 attn layer per 8), MoE every other
    # layer, 16 experts top-2 [arXiv:2403.19887].
    pattern = (M, Mm, M, Mm, A, Mm, M, Mm)
    return ArchConfig(
        name="jamba-v0.1-52b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=65536,
        pattern=pattern, n_experts=16, top_k=2,
        ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
        source="Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887]",
    ).replace(**kw)


@register_arch("whisper-small")
def whisper_small(**kw) -> ArchConfig:
    # Encoder-decoder; mel+conv frontend is a STUB (input_specs provides
    # 1500 frame embeddings). GELU MLP as in the original.
    return ArchConfig(
        name="whisper-small", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=12, head_dim=64, d_ff=3072, vocab_size=51865,
        pattern=(Ax,), act="gelu",
        encoder=EncoderConfig(n_layers=12, enc_seq=1500),
        input_mode="tokens+encoder",
        source="enc-dec, conv frontend stub [arXiv:2212.04356]",
    ).replace(**kw)


@register_arch("granite-moe-3b-a800m")
def granite_moe(**kw) -> ArchConfig:
    return ArchConfig(
        name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
        n_kv_heads=8, head_dim=64, d_ff=512, vocab_size=49155,
        pattern=(Am,), n_experts=40, top_k=8,
        source="40 experts top-8 [hf:ibm-granite/granite-3.0-*-base family]",
    ).replace(**kw)


@register_arch("h2o-danube-3-4b")
def danube3_4b(**kw) -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-3-4b", n_layers=24, d_model=3840, n_heads=32,
        n_kv_heads=8, head_dim=120, d_ff=10240, vocab_size=32000,
        pattern=(A,), window=4096,
        source="llama+mistral mix, SWA [arXiv:2401.16818]",
    ).replace(**kw)


@register_arch("deepseek-v2-lite-16b")
def deepseek_v2_lite(**kw) -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-lite-16b", n_layers=27, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1408, vocab_size=102400,
        pattern=(Am,), n_experts=64, top_k=6, n_shared_experts=2,
        kv_lora_rank=512, q_lora_rank=0,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        source="MLA kv_lora=512, shared+routed top-6 [arXiv:2405.04434]",
    ).replace(**kw)


@register_arch("mamba2-130m")
def mamba2_130m(**kw) -> ArchConfig:
    return ArchConfig(
        name="mamba2-130m", n_layers=24, d_model=768, n_heads=12,
        n_kv_heads=12, d_ff=0, vocab_size=50280,
        pattern=(M,), ssm_state=128, ssm_head_dim=64, ssm_expand=2,
        ssm_chunk=128,
        source="SSD state-space duality [arXiv:2405.21060]",
    ).replace(**kw)


@register_arch("llama-3.2-vision-11b")
def llama32_vision(**kw) -> ArchConfig:
    # 8 cross-attention layers interleaved every 5th layer; ViT/projector is
    # a STUB (input_specs provides 1600 patch embeddings at d_model).
    return ArchConfig(
        name="llama-3.2-vision-11b", n_layers=40, d_model=4096, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=128256,
        pattern=(Ax, A, A, A, A),
        encoder=EncoderConfig(n_layers=0, enc_seq=1600),
        input_mode="tokens+encoder",
        source="cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision]",
    ).replace(**kw)


@register_arch("phi3-medium-14b")
def phi3_medium(**kw) -> ArchConfig:
    return ArchConfig(
        name="phi3-medium-14b", n_layers=40, d_model=5120, n_heads=40,
        n_kv_heads=10, head_dim=128, d_ff=17920, vocab_size=100352,
        pattern=(A,), source="RoPE SwiGLU GQA [arXiv:2404.14219]",
    ).replace(**kw)
