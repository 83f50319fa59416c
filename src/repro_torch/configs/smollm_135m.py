"""--arch smollm-135m  [hf:HuggingFaceTB/SmolLM-135M; hf]
30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152 — llama-arch small."""
from repro_torch.configs.lm import LM_SHAPES as SHAPES  # noqa: F401
from repro_torch.configs.lm import SMOLLM_135M as CONFIG  # noqa: F401
from repro_torch.configs.lm import SMOLLM_135M_SMOKE as SMOKE  # noqa: F401

FAMILY = "lm"
