"""Mesh layouts, the counterparts of ``repro.launch.mesh``.

A :class:`MeshLayout` names the axes of a cluster of cards and their
sizes; it holds no device, so importing this module, or building a
production layout on a host with no card, touches none (the dry run
needs that, as the reference's does).  The paper's 1-D processor axis is
a shard group (``core/shards.py``), which does hold a device.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """Ordered axis names and their sizes, e.g. ``("data", "model")``
    and ``(16, 16)``."""

    axes: tuple
    sizes: tuple

    def __post_init__(self):
        if len(self.axes) != len(self.sizes):
            raise ValueError(f"{len(self.axes)} axes for {len(self.sizes)} "
                             f"sizes")
        if len(set(self.axes)) != len(self.axes):
            raise ValueError(f"repeated axis name in {self.axes}")

    @property
    def shape(self) -> dict:
        """``{axis: size}`` in axis order (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        """The number of cards the layout spans."""
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """One pod: (data 16, model 16) = 256 H100s.  Two pods: (pod 2,
    data 16, model 16) = 512."""
    if multi_pod:
        return MeshLayout(("pod", "data", "model"), (2, 16, 16))
    return MeshLayout(("data", "model"), (16, 16))


def make_tc_mesh(p: int | None = None, device="cuda"):
    """The paper's 1-D p-processor axis: ``LocalShards(p, device)``, p
    logical shards on one device (``p`` defaults to the cards this host
    has)."""
    import torch

    from repro_torch.core.shards import LocalShards

    return LocalShards(torch.cuda.device_count() if p is None else p, device)


def make_debug_mesh(shape=(1, 1), axes=("data", "model")) -> MeshLayout:
    return MeshLayout(tuple(axes), tuple(int(s) for s in shape))
