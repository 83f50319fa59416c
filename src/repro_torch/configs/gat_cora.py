"""--arch gat-cora  [arXiv:1710.10903; paper]  2L d_hidden=8 8 heads."""
from repro_torch.configs.gnn import GAT_CORA as CONFIG  # noqa: F401
from repro_torch.configs.gnn import GAT_CORA_SMOKE as SMOKE  # noqa: F401
from repro_torch.configs.gnn import GNN_SHAPES as SHAPES  # noqa: F401

FAMILY = "gnn"
