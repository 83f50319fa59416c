"""The port's models: the dense decoder-only LM (``transformer.py``)."""
