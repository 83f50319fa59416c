"""Entry points of the port: the LM server (``serve.py``), the trainer
(``train.py``), the triangle server (``serve_tc.py``) and its chaos
harness (``robust.py``)."""
