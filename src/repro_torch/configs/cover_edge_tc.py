"""--arch cover-edge-tc: the paper's own workload, triangle counting on
Graph500 RMAT graphs, the counterpart of ``repro.configs.cover_edge_tc``.

``CONFIG`` carries only the name; a graph's size comes from its shape.
A shape's graph (``shape_graph``) is counted by
``repro_torch.api.TriangleEngine``: the local route, or
``route="distributed"`` over a shard group with ``options()``, the
reference's TC cell's Algorithm 2 knobs.  The reference's dry-run cell
itself (``registry._tc_cell``) is XLA launch tooling and has no
counterpart here.  The family trains nothing, so ``launch/train.py``
exits on it.  ``rmat_pod`` is scale 22: its ~2.1e9 triangles wrap the
int32 c1/c2 of both packages (ROADMAP Queue 3, shared limits), so its
count is not exact; scale 20 is the largest RMAT scale whose count
fits.
"""
FAMILY = "tc"
# CONFIG carries only algorithm knobs; graph size comes from the SHAPE
CONFIG = dict(name="cover-edge-tc")
SMOKE = dict(name="cover-edge-tc-smoke")
SHAPES = {
    "rmat_pod": dict(kind="tc", scale=22, edge_factor=16),
    "rmat_smoke": dict(kind="tc", scale=10, edge_factor=16),
}


def options():
    """The ``TCOptions`` of the distributed route: the reference's TC
    cell's Algorithm 2 knobs (``repro.configs.registry._tc_cell``), ring
    mode and hedge slices of 4,096 rows.  Its ``d_pad`` of 256 sizes a
    dry run's static shapes; the engine takes the graph's own maximum
    degree."""
    from repro_torch.api import TCOptions

    return TCOptions(mode="ring", hedge_chunk=4096)


def shape_graph(shape: str, seed: int = 0):
    """``(edges, n_nodes)`` of ``shape``: ``rmat(scale, edge_factor,
    seed)``, Graph500's generator."""
    from repro_torch.graph import generators as gen

    info = SHAPES[shape]
    return gen.rmat(info["scale"], info["edge_factor"], seed=seed)
