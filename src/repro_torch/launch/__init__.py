"""Entry points of the port's model paths: the LM server (``serve.py``)."""
