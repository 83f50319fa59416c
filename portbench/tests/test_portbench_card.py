"""On the card only (marker ``cuda``; skipped with a reason elsewhere):
the generators on the card are seeded, and the reference agrees with
the port's count there at a small size.  Run with ``pytest -m cuda``."""
import _setup  # noqa: F401
import numpy as np
import pytest
import torch

from portbench import graphs, reference

RMAT12 = {"generator": "rmat", "scale": 12, "edge_factor": 16,
          "a": 0.57, "b": 0.19, "c": 0.19, "pool_seeds": [1, 2]}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_pool_on_the_card_is_seeded(card):
    a, wa = graphs.make_pool(RMAT12, 2**31 + 3, card)
    b, wb = graphs.make_pool(RMAT12, 2**31 + 3, card)
    for (x, _), (y, _) in zip(a + [wa], b + [wb]):
        assert np.array_equal(x, y)


@pytest.mark.cuda
def test_reference_equals_the_port_on_the_card(card):
    from repro_torch.api import TCOptions, TriangleEngine

    edges, n = graphs.make_pool(RMAT12, 5, card)[0][0]
    rep = TriangleEngine(device=card).count(
        (edges, n), route="local", options=TCOptions(per_vertex=True))
    t, pv = reference.triangles(edges, n, device=card, per_vertex=True)
    assert t == rep.triangles
    assert np.array_equal(pv.cpu().numpy(), rep.per_vertex)
