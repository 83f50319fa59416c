"""The model zoo's distribution rules: the ambient mesh and its
constraints (``constrain.py``) and the per-family sharding rules
(``sharding.py``), the counterparts of ``repro.distributed``."""
