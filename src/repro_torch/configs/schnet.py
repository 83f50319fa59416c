"""--arch schnet  [arXiv:1706.08566; paper]  3 interactions d=64 rbf=300."""
from repro_torch.configs.gnn import SCHNET as CONFIG  # noqa: F401
from repro_torch.configs.gnn import SCHNET_SMOKE as SMOKE  # noqa: F401
from repro_torch.configs.gnn import GNN_SHAPES as SHAPES  # noqa: F401

FAMILY = "gnn"
