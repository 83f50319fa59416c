"""--arch dimenet  [arXiv:2003.03123; unverified]
6 blocks d_hidden=128 n_bilinear=8 n_spherical=7 n_radial=6."""
from repro_torch.configs.gnn import DIMENET as CONFIG  # noqa: F401
from repro_torch.configs.gnn import DIMENET_SMOKE as SMOKE  # noqa: F401
from repro_torch.configs.gnn import GNN_SHAPES as SHAPES  # noqa: F401

FAMILY = "gnn"
