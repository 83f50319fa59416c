"""--arch gatedgcn  [arXiv:2003.00982; paper]  16L d_hidden=70 gated agg."""
from repro_torch.configs.gnn import GATEDGCN as CONFIG  # noqa: F401
from repro_torch.configs.gnn import GATEDGCN_SMOKE as SMOKE  # noqa: F401
from repro_torch.configs.gnn import GNN_SHAPES as SHAPES  # noqa: F401

FAMILY = "gnn"
