"""--arch bst  [arXiv:1905.06874; paper]  Behavior Sequence Transformer."""
from repro_torch.configs.recsys import BST as CONFIG  # noqa: F401
from repro_torch.configs.recsys import BST_SMOKE as SMOKE  # noqa: F401
from repro_torch.configs.recsys import RECSYS_SHAPES as SHAPES  # noqa: F401

FAMILY = "recsys"
