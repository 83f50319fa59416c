"""The port's graph neural networks (GatedGCN; GAT, SchNet and DimeNet
wait for ROADMAP Queue 1 item 13)."""
