"""The graphs a run hands the program, made from ``--seed``.

Each pool entry starts from a base graph of the configuration's
generator (``generators/<name>.py``), drawn from one of the fixed base
seeds the configuration lists (``pool_seeds``: the first few whole
numbers, not chosen by any property of the graph).  The run's seed then
relabels its vertices by a random permutation and shuffles the order of
its edge rows.  The permutation is not uniform: it sends the base
graph's *root*, the smallest vertex of its largest connected component,
to label 0, the BFS root of ``TCOptions()``.  So every seed gets the
same graphs up to isomorphism, with the BFS started at the same vertex
of the giant component: the seed changes the inputs and hardly the
work.  Graph500 does the like when it draws its BFS roots among the
vertices that have edges; a uniformly relabelled draw would put label 0
on an edge-less vertex about half the time at scale 20 and start the
giant component's BFS wherever its smallest label fell, a change of
work from seed to seed.  Only the small components, each reseeded at
its smallest vertex, may start elsewhere.

The warm-up graph is the first base graph under a permutation of its
own: the same shapes as the window's first graph, and edges that no
request of the window carries.

The graphs are made on ``device`` and handed over as host ``int64[m,
2]`` numpy arrays, as a user holds an edge list.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def load_module(kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py``, loaded by its path."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('-', '_').replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_seed(seed: int, slot: int) -> int:
    """A 63-bit generator seed for pool slot ``slot`` of run ``seed``
    (any whole number, also past 32 bits)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), int(slot)])
    return int(ss.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def giant_root(edges: torch.Tensor, n: int) -> int:
    """The smallest vertex of the largest connected component of the
    graph ``edges`` (the smallest such vertex where sizes tie): min-label
    propagation with pointer jumping."""
    src, dst = edges[:, 0], edges[:, 1]
    comp = torch.arange(n, dtype=torch.int64, device=edges.device)
    while True:
        low = torch.minimum(comp[src], comp[dst])
        new = comp.scatter_reduce(0, src, low, "amin")
        new.scatter_reduce_(0, dst, low, "amin")
        new = new[new]
        if torch.equal(new, comp):
            break
        comp = new
    return int(torch.bincount(comp, minlength=n).argmax())


def relabel(edges: torch.Tensor, n: int, root: int,
            gen: torch.Generator) -> torch.Tensor:
    """``edges`` under a random permutation of the labels that sends
    ``root`` to 0, its rows in a random order."""
    dev = edges.device
    perm = torch.empty(n, dtype=torch.int64, device=dev)
    perm[root] = 0
    rest = torch.ones(n, dtype=torch.bool, device=dev)
    rest[root] = False
    perm[rest] = 1 + torch.randperm(n - 1, generator=gen, device=dev)
    order = torch.randperm(edges.shape[0], generator=gen, device=dev)
    return perm[edges[order]]


def make_pool(cfg: dict, seed: int, device: torch.device
              ) -> tuple[list[tuple[np.ndarray, int]], tuple[np.ndarray, int]]:
    """``(pool, warm)``: the run's graphs, one per base seed of
    ``cfg["pool_seeds"]``, and the warm-up graph, each relabelled from
    ``seed`` (module docstring)."""
    make = load_module("generators", cfg["generator"]).make
    bases = [int(b) for b in cfg["pool_seeds"]]

    def relabelled(edges, n, root, slot):
        r = torch.Generator(device=device)
        r.manual_seed(run_seed(seed, slot))
        return relabel(edges, n, root, r).cpu().numpy(), n

    pool, warm = [], None
    for slot, base in enumerate(bases):
        g = torch.Generator(device=device)
        g.manual_seed(base)
        edges, n = make(cfg, g)
        root = giant_root(edges, n)
        pool.append(relabelled(edges, n, root, slot))
        if slot == 0:
            warm = relabelled(edges, n, root, len(bases))
        del edges
    return pool, warm
