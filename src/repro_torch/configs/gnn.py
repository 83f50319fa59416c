"""The four GNN architectures the port trains and the GNN shape pool,
the counterparts of ``repro.configs.gnn``.

The shapes carry the exact public sizes; the molecular nets (SchNet,
DimeNet) get synthesized positions and atom types on non-molecular
graphs.
"""
from __future__ import annotations

from repro_torch.models.gnn.dimenet import DimeNetConfig
from repro_torch.models.gnn.gat import GATConfig
from repro_torch.models.gnn.gatedgcn import GatedGCNConfig
from repro_torch.models.gnn.schnet import SchNetConfig

GATEDGCN = GatedGCNConfig(name="gatedgcn", n_layers=16, d_hidden=70)
GATEDGCN_SMOKE = GatedGCNConfig(name="gatedgcn-smoke", n_layers=3,
                                d_hidden=16, d_in=8, n_classes=4)

GAT_CORA = GATConfig(name="gat-cora", n_layers=2, d_hidden=8, n_heads=8)
GAT_CORA_SMOKE = GATConfig(name="gat-cora-smoke", n_layers=2, d_hidden=4,
                           n_heads=2, d_in=8, n_classes=3)

DIMENET = DimeNetConfig(name="dimenet", n_blocks=6, d_hidden=128,
                        n_bilinear=8, n_spherical=7, n_radial=6)
DIMENET_SMOKE = DimeNetConfig(name="dimenet-smoke", n_blocks=2, d_hidden=16,
                              n_bilinear=2, n_spherical=3, n_radial=2)

SCHNET = SchNetConfig(name="schnet", n_interactions=3, d_hidden=64,
                      n_rbf=300, cutoff=10.0)
SCHNET_SMOKE = SchNetConfig(name="schnet-smoke", n_interactions=2,
                            d_hidden=16, n_rbf=20)

# GNN shape pool — n_edges are UNDIRECTED counts from the public datasets;
# edge arrays are 2x (symmetrized directed).  triplet_cap bounds DimeNet's
# quadratic triplet table (truncation logged by the data layer).
GNN_SHAPES = {
    "full_graph_sm": dict(               # Cora
        kind="train", n_nodes=2708, n_edges=10556, d_feat=1433,
        n_graphs=1, triplet_factor=8,
    ),
    "minibatch_lg": dict(                # Reddit-scale sampled training
        kind="train", n_nodes=232965, n_edges=114615892, batch_nodes=1024,
        fanout=(15, 10), d_feat=602, n_graphs=1, triplet_factor=4,
    ),
    "ogb_products": dict(                # full-batch-large
        kind="train", n_nodes=2449029, n_edges=61859140, d_feat=100,
        n_graphs=1, triplet_factor=2,
    ),
    "molecule": dict(                    # batched small graphs
        kind="train", n_nodes=30, n_edges=64, batch=128, d_feat=16,
        triplet_factor=8,
    ),
}
