"""The 10 assigned architectures, exact published configs.

Sources are cited per-arch; shapes pairing per the assignment:
train_4k / prefill_32k / decode_32k always; long_500k only for
sub-quadratic archs (rwkv6, jamba, mixtral-SWA) — see docs/design.md §6.
"""
from .base import ATTN, MAMBA, RWKV, ModelConfig

MISTRAL_NEMO_12B = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072, rope_theta=1_000_000.0,
    notes="[hf:mistralai/Mistral-Nemo-Base-2407] 128k ctx, GQA kv=8",
)

PHI4_MINI_3_8B = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=200064, rope_theta=10_000.0,
    notes="[arXiv:2412.08905] RoPE SwiGLU GQA; 24 heads -> seq-shard attention TP fallback",
)

QWEN3_4B = ModelConfig(
    name="qwen3-4b", family="dense",
    num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=9728, vocab_size=151936, qk_norm=True, rope_theta=1_000_000.0,
    notes="[hf:Qwen/Qwen3-8B family] qk_norm, decoupled head_dim=128 (H*Dh != d_model)",
)

LLAMA3_8B = ModelConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, rope_theta=500_000.0,
    notes="[arXiv:2407.21783] GQA, 128k vocab",
)

PHI35_MOE = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=6400, vocab_size=32064,
    num_experts=16, experts_per_token=2, rope_theta=10_000.0,
    notes="[hf:microsoft/Phi-3.5-MoE-instruct] 16 experts top-2, every layer MoE",
)

MIXTRAL_8X7B = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    num_experts=8, experts_per_token=2, sliding_window=4096,
    rope_theta=1_000_000.0, subquadratic=True,
    notes="[arXiv:2401.04088] 8e top-2, SWA(4096) => long_500k eligible (bounded KV)",
)

RWKV6_1_6B = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=7168, vocab_size=65536, rwkv_head_dim=64,
    block_pattern=(RWKV,), subquadratic=True,
    notes="[arXiv:2404.05892] Finch: data-dependent decay; attention-free",
)

WHISPER_SMALL = ModelConfig(
    name="whisper-small", family="encdec",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51865,
    encoder_layers=12, encoder_seq=1500, rope_theta=0.0,  # learned abs pos
    notes="[arXiv:2212.04356] enc-dec; conv frontend stubbed as frame embeddings",
)

LLAVA_NEXT_34B = ModelConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000,
    num_image_tokens=2880, rope_theta=5_000_000.0,
    notes="[hf:llava-hf family] anyres tiling stubbed: 2880 patch-embed tokens (5 tiles x 576)",
)

JAMBA_V01_52B = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    num_experts=16, experts_per_token=2,
    moe_every=2, moe_offset=1,       # every other layer MoE (Jamba paper)
    block_pattern=(MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA, MAMBA),
    ssm_state_dim=16, ssm_expand=2, ssm_conv_width=4, subquadratic=True,
    notes="[arXiv:2403.19887] attn:mamba 1:7, MoE every other layer, 16e top-2",
)

ARCHS = {c.name: c for c in (
    MISTRAL_NEMO_12B, PHI4_MINI_3_8B, QWEN3_4B, LLAMA3_8B, PHI35_MOE,
    MIXTRAL_8X7B, RWKV6_1_6B, WHISPER_SMALL, LLAVA_NEXT_34B, JAMBA_V01_52B,
)}
