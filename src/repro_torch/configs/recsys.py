"""BST (recsys) configs and shape pool, the counterparts of
``repro.configs.recsys``."""
from __future__ import annotations

from repro_torch.models.recsys.bst import BSTConfig

BST = BSTConfig(
    name="bst", embed_dim=32, seq_len=20, n_blocks=1, n_heads=8,
    mlp_dims=(1024, 512, 256), item_vocab=1_048_576, profile_vocab=65_536,
    profile_bag=8,
)
BST_SMOKE = BSTConfig(
    name="bst-smoke", embed_dim=16, seq_len=20, n_blocks=1, n_heads=4,
    mlp_dims=(64, 32), item_vocab=1024, profile_vocab=128, profile_bag=4,
)

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1,
                           n_candidates=1_000_000),
}
