"""Process-wide counters of the host's waits for the card and of the
bytes it reads back, the counterpart for the host-card boundary of
``kernels/intersect/intersect.py:LAUNCHES``.

``HOST_IO["syncs"]`` counts each place where the host waits for the
card: a scalar read (``.item()``), a copy to the host, a blocking copy
to the card (a Python scalar written into a card tensor is one too), and
an op whose output size the host must learn first (``torch.unique``,
``torch.bincount``, ``nonzero``, an index by a bool mask).
``HOST_IO["d2h_bytes"]`` counts the bytes of the tensors the port itself
copies to the host, ``numel * element_size`` from their host-side
metadata.  The sites bump them beside the wait, with no read of their
own; they count the same on the CPU as on the card, so a CPU run shows
what the card would wait for.  ``StageClock`` records each stage's
share (``core/sequential.py``).

Nothing in this module imports the rest of ``repro_torch``.
"""
from __future__ import annotations

#: counter name -> count in this process
HOST_IO = {"syncs": 0, "d2h_bytes": 0}


def note_wait(n: int = 1) -> None:
    """Count ``n`` host waits that read nothing back."""
    HOST_IO["syncs"] += n


def note_read_back(*tensors) -> None:
    """Count one host wait and the bytes of each tensor read back."""
    for t in tensors:
        HOST_IO["syncs"] += 1
        HOST_IO["d2h_bytes"] += t.numel() * t.element_size()
