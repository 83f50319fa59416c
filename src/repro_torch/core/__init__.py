"""The triangle engine of the port: Algorithm 1 (BFS, edge classes, the
intersection engine), Algorithm 2 over a shard group (``shards.py``,
``sampling.py``, ``parallel_tc.py``, its communication accounting in
``comm_model.py`` and ``comm_instrument.py``), the wedge-sampled
estimator (``approx.py``) and the wedge baseline
(``wedge_baseline.py``)."""
