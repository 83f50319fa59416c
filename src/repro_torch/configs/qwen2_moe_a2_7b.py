"""--arch qwen2-moe-a2.7b  [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
24L d_model=2048 16H d_ff=1408/expert vocab=151936, 60 routed top-4 + 4 shared."""
from repro_torch.configs.lm import LM_SHAPES as SHAPES  # noqa: F401
from repro_torch.configs.lm import QWEN2_MOE_A2_7B as CONFIG  # noqa: F401
from repro_torch.configs.lm import QWEN2_MOE_SMOKE as SMOKE  # noqa: F401

FAMILY = "lm"
