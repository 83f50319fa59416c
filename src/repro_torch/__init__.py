"""repro_torch — the PyTorch/CUDA port of the cover-edge triangle engine.

The package mirrors ``repro`` module for module, so each function has a
counterpart of the same name there.  It imports ``torch`` and numpy and
never JAX.  Its hot kernel (``kernels/intersect``) is hand-written CUDA
C++ for Hopper (``sm_90a``), built with ``nvcc`` at first use.

Every entry point takes a ``device`` and defaults to ``"cuda"``; on a
host without a card it raises unless the caller passes ``device="cpu"``.

    from repro_torch.api import TriangleEngine

    report = TriangleEngine().count((edges, n_nodes))
    print(report.triangles, report.k, report.backend)
"""

__version__ = "0.1.0"
