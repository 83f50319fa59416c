"""--arch gemma3-4b  [hf:google/gemma-3-*-pt; unverified]
34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144 — 5:1 local:global."""
from repro_torch.configs.lm import LM_SHAPES as SHAPES  # noqa: F401
from repro_torch.configs.lm import GEMMA3_4B as CONFIG  # noqa: F401
from repro_torch.configs.lm import GEMMA3_4B_SMOKE as SMOKE  # noqa: F401

FAMILY = "lm"
