"""--arch phi3.5-moe-42b-a6.6b  [hf:microsoft/Phi-3.5-MoE-instruct; hf]
32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16e top-2."""
from repro_torch.configs.lm import LM_SHAPES as SHAPES  # noqa: F401
from repro_torch.configs.lm import PHI35_MOE as CONFIG  # noqa: F401
from repro_torch.configs.lm import PHI35_MOE_SMOKE as SMOKE  # noqa: F401

FAMILY = "lm"
