"""K1: the level-split sorted-list intersection (CUDA + plain)."""
