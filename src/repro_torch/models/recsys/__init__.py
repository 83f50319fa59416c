"""The port's recommendation models: the Behavior Sequence Transformer
(``bst.py``)."""
