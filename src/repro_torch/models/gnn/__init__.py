"""The port's graph neural networks: GatedGCN, GAT, SchNet and DimeNet,
every aggregation a segment sum through K4 on the card."""
