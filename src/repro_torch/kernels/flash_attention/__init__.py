"""K5: causal, windowed, grouped-query attention (``csrc/flash_attention.cu``)
beside its plain PyTorch version (``ref.py``)."""
