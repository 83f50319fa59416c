"""K4: the segment sum of edge messages (``csrc/segsum.cu``) beside its
plain PyTorch version (``ref.py``)."""
