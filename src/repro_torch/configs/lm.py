"""The LM architectures the port trains and serves (exact public
configs), the counterparts of ``repro.configs.lm``'s entries.

``*_SMOKE`` variants shrink width, depth and vocab only: the same code
paths and family pattern (GQA ratios, gemma3's 5:1 local:global, MoE
top-k).

``OPT`` holds the reference's execution knobs that the port's configs
also have (model-math preserving): ``attn_impl="chunked"`` (the same
function as "dense" here: both go through K5), bf16 activations with
float32 master weights, and for the MoE LMs the explicit expert-parallel
dispatch (``models/moe_a2a.py``, under a mesh with a ``model`` axis).
The dataclass defaults are the faithful baseline.  ``LM_SHAPES`` is the
shape pool of the dry run's cells (``configs/registry.py``).
"""
from __future__ import annotations

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

OPT = dict(attn_impl="chunked", act_dtype="bfloat16")
OPT_MOE = {"moe.dispatch": "a2a", **OPT}

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

# [hf:Qwen/Qwen1.5-MoE-A2.7B; hf] — 60 routed top-4 + 4 shared (4x1408 GLU)
QWEN2_MOE_A2_7B = LMConfig(
    name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=16, d_head=128, d_ff=5632, vocab=151936, act="silu",
    rope_theta=1_000_000.0, tie_embeddings=False,
    moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408,
                  d_ff_shared=5632, capacity_factor=1.25,
                  pad_experts_to=64),  # the reference's 64 slots
)
QWEN2_MOE_SMOKE = LMConfig(
    name="qwen2-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=128, vocab=256, act="silu", tie_embeddings=False,
    moe=MoEConfig(n_experts=8, top_k=4, d_ff_expert=32, d_ff_shared=128),
)

# [hf:microsoft/Phi-3.5-MoE-instruct; hf] — 16 experts top-2
PHI35_MOE = LMConfig(
    name="phi3.5-moe-42b-a6.6b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_head=128, d_ff=6400, vocab=32064, act="silu",
    rope_theta=10_000.0, tie_embeddings=False,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400,
                  capacity_factor=1.25),
)
PHI35_MOE_SMOKE = LMConfig(
    name="phi3.5-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, vocab=256, act="silu", tie_embeddings=False,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64),
)

# LM shape pool: (name, kind, seq_len, global_batch)
LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

# pure full-attention archs skip long_500k (a 512k dense-cache decode is
# the quadratic regime the pool excludes them from); gemma3's 5:1
# sliding-window hybrids run it
LONG_CONTEXT_OK = {"gemma3-4b", "gemma3-1b"}
