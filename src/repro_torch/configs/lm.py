"""The dense LM architectures the port serves (exact public configs), the
counterparts of ``repro.configs.lm``'s dense entries.

``*_SMOKE`` variants shrink width, depth and vocab only: the same code
paths and family pattern (GQA ratios, gemma3's 5:1 local:global).  The
MoE configs (qwen2-moe, phi3.5-moe) wait for ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

from repro_torch.models.transformer import LMConfig

# [hf:HuggingFaceTB/SmolLM-135M; hf] — llama-arch small
SMOLLM_135M = LMConfig(
    name="smollm-135m", n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_head=64, d_ff=1536, vocab=49152, act="silu", rope_theta=10_000.0,
    tie_embeddings=True,
)
SMOLLM_135M_SMOKE = LMConfig(
    name="smollm-135m-smoke", n_layers=3, d_model=96, n_heads=3, n_kv_heads=1,
    d_head=32, d_ff=256, vocab=512, act="silu",
)

# [hf:google/gemma-3-*-pt; unverified] — 5:1 local:global sliding window
GEMMA3_4B = LMConfig(
    name="gemma3-4b", n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
    d_head=256, d_ff=10240, vocab=262144, act="gelu", window=1024,
    global_every=6, rope_theta=1_000_000.0, qk_norm=True,
    tie_embeddings=True,
)
GEMMA3_4B_SMOKE = LMConfig(
    name="gemma3-4b-smoke", n_layers=6, d_model=128, n_heads=4, n_kv_heads=2,
    d_head=32, d_ff=512, vocab=512, act="gelu", window=16, global_every=6,
    qk_norm=True,
)

GEMMA3_1B = LMConfig(
    name="gemma3-1b", n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
    d_head=256, d_ff=6912, vocab=262144, act="gelu", window=512,
    global_every=6, rope_theta=1_000_000.0, qk_norm=True,
    tie_embeddings=True,
)
GEMMA3_1B_SMOKE = LMConfig(
    name="gemma3-1b-smoke", n_layers=6, d_model=96, n_heads=2, n_kv_heads=1,
    d_head=48, d_ff=384, vocab=512, act="gelu", window=16, global_every=6,
    qk_norm=True,
)
