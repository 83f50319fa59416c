"""``repro_torch.train.trainer.int8_compressed_psum`` held against
``repro.train.trainer.int8_compressed_psum`` on the CPU.

The reference runs under ``shard_map`` in a subprocess on 4 forced host
devices, over meshes of 2 and 4 of them, on per-shard gradient trees
whose shards have unequal absmax (scales spread over three decades).
The port runs the same numpy trees over ``LocalShards`` and over
``GroupShards`` on gloo: the results equal bit for bit.  Also the
reference's one-device property (``tests/test_train_infra.py``) and its
shared-scale defect: two shards [1.0, 0.5] and [0.1, 0.05] sum to
[2.0, 1.008], not [1.1, 0.55] (ROADMAP, reference caveat 6)."""
from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.shards import LocalShards
from repro_torch.train.trainer import int8_compressed_psum

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLDS = (2, 4)
SEEDS = (0, 1)

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.train.trainer import int8_compressed_psum
for inp, outp in zip(sys.argv[1::2], sys.argv[2::2]):
    z = np.load(inp)
    tree = {k: jnp.asarray(z[k]) for k in z.files}
    n = next(iter(tree.values())).shape[0]
    mesh = Mesh(np.array(jax.devices()[:n]), ("d",))
    f = jax.jit(shard_map(
        lambda t: int8_compressed_psum({k: v[0] for k, v in t.items()}, "d"),
        mesh=mesh, in_specs=({k: P("d") for k in tree},),
        out_specs={k: P() for k in tree}))
    np.savez(outp, **{k: np.asarray(v) for k, v in f(tree).items()})
print("REF_OK")
"""


def _tree(n: int, seed: int) -> dict:
    """A per-shard gradient tree ``[n, ...]`` whose shards' absmax differ
    (each shard scaled by 10^-u, u uniform in [0, 3))."""
    rng = np.random.default_rng(seed)
    scale = (10.0 ** -rng.uniform(0, 3, n)).astype(np.float32)
    return {
        "w": (rng.standard_normal((n, 33, 7)) * scale[:, None, None]
              ).astype(np.float32),
        "b": (rng.standard_normal((n, 50)) * scale[::-1, None]
              ).astype(np.float32),
        "ln": (rng.standard_normal((n, 3, 2, 5)) * scale[:, None, None,
                                                          None]
               ).astype(np.float32),
    }


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("psum")
    argv = []
    for n in WORLDS:
        for seed in SEEDS:
            np.savez(d / f"in_{n}_{seed}.npz", **_tree(n, seed))
            argv += [str(d / f"in_{n}_{seed}.npz"),
                     str(d / f"out_{n}_{seed}.npz")]
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REF, *argv], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and "REF_OK" in out.stdout, \
        out.stderr[-3000:]
    return {(n, s): dict(np.load(d / f"out_{n}_{s}.npz"))
            for n in WORLDS for s in SEEDS}


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", WORLDS)
def test_local_shards_equal_reference_bits(ref, n, seed):
    tree = {k: torch.from_numpy(v) for k, v in _tree(n, seed).items()}
    got = int8_compressed_psum(tree, LocalShards(n, "cpu"))
    want = ref[(n, seed)]
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.shape == want[k].shape
        assert np.array_equal(_bits(v.numpy()), _bits(want[k])), k


def test_reference_shared_scale_defect_reproduced():
    g = torch.tensor([[1.0, 0.5], [0.1, 0.05]])
    out = int8_compressed_psum(g, LocalShards(2, "cpu"))
    np.testing.assert_allclose(out.numpy(), [2.0, 1.0079], atol=1e-4)
    # the exact sum is [1.1, 0.55]: the second shard comes back 10x
    assert abs(float(out[0]) - 1.1) > 0.8


def test_single_shard_property():
    """The reference's one-device property: the error of a round trip is
    at most absmax / 127."""
    g = np.random.default_rng(0).standard_normal(128).astype(np.float32)
    out = int8_compressed_psum({"w": torch.from_numpy(g)[None]},
                               LocalShards(1, "cpu"))["w"].numpy()
    assert float(np.abs(out - g).max()) <= np.abs(g).max() / 127.0 + 1e-6


def test_records_one_psum_and_one_pmax_a_leaf():
    shards = LocalShards(2, "cpu")
    tree = {k: torch.from_numpy(v) for k, v in _tree(2, 0).items()}
    with shards.recording() as rec:
        int8_compressed_psum(tree, shards)
    assert [c.kind for c in rec] == ["psum", "pmax"] * len(tree)
    assert [c.dtype for c in rec[::2]] == ["int32"] * len(tree)


_RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, init, inp, outp = sys.argv[1:6]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=world)
from repro_torch.core.shards import GroupShards
from repro_torch.train.trainer import int8_compressed_psum
z = np.load(inp)
tree = {k: torch.from_numpy(z[k][rank:rank + 1].copy()) for k in z.files}
out = int8_compressed_psum(tree, GroupShards())
np.savez(outp, **{k: v.numpy() for k, v in out.items()})
dist.destroy_process_group()
print("RANK_OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n", WORLDS)
def test_group_shards_over_gloo_equal_reference_bits(ref, tmp_path, n):
    np.savez(tmp_path / "in.npz", **_tree(n, 0))
    init = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(n), init,
         str(tmp_path / "in.npz"), str(tmp_path / f"r{r}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    try:
        for pr in procs:
            so, se = pr.communicate(timeout=300)
            assert pr.returncode == 0 and "RANK_OK" in so, se[-3000:]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    want = ref[(n, 0)]
    for r in range(n):
        got = np.load(tmp_path / f"r{r}.npz")
        for k in want:
            assert np.array_equal(_bits(got[k]), _bits(want[k])), (r, k)
