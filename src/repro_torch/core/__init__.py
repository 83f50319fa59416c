"""Algorithm 1 of the port: BFS, edge classes, the intersection engine,
the wedge-sampled estimator (``approx.py``) and the wedge baseline
(``wedge_baseline.py``)."""
