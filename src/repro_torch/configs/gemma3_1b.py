"""--arch gemma3-1b  [hf:google/gemma-3-1b-pt; unverified]
26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144 — 5:1 local:global."""
from repro_torch.configs.lm import LM_SHAPES as SHAPES  # noqa: F401
from repro_torch.configs.lm import GEMMA3_1B as CONFIG  # noqa: F401
from repro_torch.configs.lm import GEMMA3_1B_SMOKE as SMOKE  # noqa: F401

FAMILY = "lm"
