"""The port's explicit expert-parallel MoE (``repro_torch.models.moe_a2a``)
held against ``repro.models.moe_a2a`` on the CPU.

The reference runs in a subprocess on 8 forced host devices, a ``(data 2,
model 4)`` mesh under ``repro.compat.set_mesh``: ``moe_ffn`` with
``dispatch="a2a"`` (its shard_map path only; the reference's gspmd path
is not called under the mesh), its output, aux loss, and ``jax.grad`` of
``out.sum()`` and of the aux loss alone (the router's gradient through
the ``pmean`` of the load-balancing statistics) for three cases: capacity factor 16 (nothing dropped),
1.0 (per-slice capacity drops entries) and 6 routed experts padded to 8
slots.  The port runs the same numpy inputs under ``use_mesh`` with a
``(data 2, model 4)`` layout over ``LocalShards(4, "cpu")``.

Tolerances (float32 through both packages, sums in other orders): the
output within OUT_TOL * (1 + |ref|), the aux loss within AUX_TOL, the
gradients within GRAD_TOL * (1 + |ref|).  Also: at cf 16 the a2a path
equals the port's sort path; without a ``model`` axis (or at S = 1)
``dispatch="a2a"`` gives the sort path's bits; the collectives recorded;
an LM under the mesh; and ``GroupShards`` over 2 and 4 gloo ranks equal
to ``LocalShards``, the gradients of ``out.sum() + aux`` too."""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import lm as tlm
from repro_torch.core.shards import LocalShards
from repro_torch.distributed.constrain import current_mesh, use_mesh
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models import moe_a2a as ta2a
from repro_torch.models import transformer as ttfm

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
OUT_TOL = 1e-5
AUX_TOL = 1e-6
GRAD_TOL = 1e-4
D = 16
X_SHAPE = (4, 8, D)   # B divides over data 2, S over model 4

CASES = {
    "cf16": dict(n_experts=8, top_k=2, d_ff_expert=32, d_ff_shared=64,
                 capacity_factor=16.0),
    "cf1": dict(n_experts=8, top_k=2, d_ff_expert=32, d_ff_shared=64,
                capacity_factor=1.0),
    "padded-6-on-8": dict(n_experts=6, top_k=2, d_ff_expert=32,
                          capacity_factor=1.0, pad_experts_to=8),
}
LEAVES = ("w_gate", "w_up", "w_down")

_REF = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import set_mesh
from repro.models.moe import MoEConfig, moe_ffn

mesh = jax.make_mesh((2, 4), ("data", "model"))
for inp, outp in zip(sys.argv[1::2], sys.argv[2::2]):
    z = np.load(inp)
    cfg = MoEConfig(**json.loads(str(z["cfg"])))
    assert cfg.dispatch == "a2a"
    params = {"router": z["router"], "experts": {
        k: z["experts." + k] for k in ("w_gate", "w_up", "w_down")}}
    if cfg.d_ff_shared:
        params["shared"] = {k: z["shared." + k]
                            for k in ("w_gate", "w_up", "w_down")}
    with set_mesh(mesh):
        xs = jax.device_put(jnp.asarray(z["x"]),
                            NamedSharding(mesh, P("data", None, None)))
        ps = jax.device_put(jax.tree.map(jnp.asarray, params), jax.tree.map(
            lambda _: NamedSharding(mesh, P()), params))
        out, aux = jax.jit(lambda p, x: moe_ffn(p, cfg, x))(ps, xs)
        gp, gx = jax.jit(jax.grad(lambda p, x: moe_ffn(p, cfg, x)[0].sum(),
                                  argnums=(0, 1)))(ps, xs)
        ap, ax = jax.jit(jax.grad(lambda p, x: moe_ffn(p, cfg, x)[1],
                                  argnums=(0, 1)))(ps, xs)
    res = {"out": np.asarray(out), "aux": np.asarray(aux),
           "grad.x": np.asarray(gx), "auxgrad.x": np.asarray(ax)}
    for tag, g in (("grad.", gp), ("auxgrad.", ap)):
        for path, v in jax.tree_util.tree_flatten_with_path(g)[0]:
            res[tag + ".".join(k.key for k in path)] = np.asarray(v)
    np.savez(outp, **res)
print("REF_OK")
"""


def _inputs(kw: dict, seed: int = 0) -> dict:
    """The layer's numpy weights and input of ``kw`` from ``seed``."""
    cfg = tmoe.MoEConfig(**kw)
    rng = np.random.default_rng(seed)
    e, f = cfg.n_phys, cfg.d_ff_expert

    def w(*shape):
        return (rng.standard_normal(shape)
                / np.sqrt(shape[-2])).astype(np.float32)

    z = {"router": w(D, e), "experts.w_gate": w(e, D, f),
         "experts.w_up": w(e, D, f), "experts.w_down": w(e, f, D)}
    if cfg.d_ff_shared:
        s = cfg.d_ff_shared
        z.update({"shared.w_gate": w(D, s), "shared.w_up": w(D, s),
                  "shared.w_down": w(s, D)})
    z["x"] = rng.standard_normal(X_SHAPE).astype(np.float32)
    return z


def _params(z: dict, grad: bool = False) -> tuple[dict, dict]:
    """``(params, leaves)``: the port's ``MoE.leaves()`` tree of ``z`` and
    the flat tensors by name."""
    t = {k: torch.from_numpy(v.copy()).requires_grad_(grad)
         for k, v in z.items() if k != "cfg"}
    params = {"router": t["router"],
              "experts": {k: t["experts." + k] for k in LEAVES}}
    if "shared.w_gate" in t:
        params["shared"] = {k: t["shared." + k] for k in LEAVES}
    return params, t


def _mesh(n_data=2, n_model=4):
    return use_mesh(make_debug_mesh((n_data, n_model)),
                    LocalShards(n_model, "cpu"))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("a2a")
    argv = []
    for name, kw in CASES.items():
        z = _inputs({**kw, "dispatch": "a2a"})
        z["cfg"] = json.dumps({**kw, "dispatch": "a2a"})
        np.savez(d / f"{name}_in.npz", **z)
        argv += [str(d / f"{name}_in.npz"), str(d / f"{name}_out.npz")]
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REF, *argv], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and "REF_OK" in out.stdout, \
        out.stderr[-3000:]
    return {name: dict(np.load(d / f"{name}_out.npz")) for name in CASES}


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float((np.abs(got - want) / (1 + np.abs(want))).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_a2a_matches_reference(ref, case):
    kw = {**CASES[case], "dispatch": "a2a"}
    cfg = tmoe.MoEConfig(**kw)
    z = _inputs(kw)
    params, t = _params(z, grad=True)
    with _mesh():
        out, aux = tmoe.moe_ffn(params, cfg, t["x"])
        out.sum().backward()
    r = ref[case]
    assert _rel(out.detach().numpy(), r["out"]) <= OUT_TOL
    assert abs(float(aux.detach()) - float(r["aux"])) <= AUX_TOL
    grads = [k for k in r if k.startswith("grad.")]
    assert len(grads) == len(t)  # every leaf and x
    for k in grads:
        assert _rel(t[k[5:]].grad.numpy(), r[k]) <= GRAD_TOL, k


@pytest.mark.parametrize("case", sorted(CASES))
def test_a2a_aux_grad_matches_reference(ref, case):
    """The aux loss's gradient alone: the router's and the input's through
    the per-slice softmax and ``pmean``; the experts' are zero."""
    kw = {**CASES[case], "dispatch": "a2a"}
    z = _inputs(kw)
    params, t = _params(z, grad=True)
    with _mesh():
        _, aux = tmoe.moe_ffn(params, tmoe.MoEConfig(**kw), t["x"])
        aux.backward()
    r = ref[case]
    grads = [k for k in r if k.startswith("auxgrad.")]
    assert len(grads) == len(t)
    assert np.abs(r["auxgrad.router"]).max() > 0
    for k in grads:
        g = t[k[8:]].grad
        got = np.zeros_like(r[k]) if g is None else g.numpy()
        assert _rel(got, r[k]) <= GRAD_TOL, k


def test_a2a_at_cf16_equals_sort_path():
    kw = CASES["cf16"]
    z = _inputs(kw)
    params, t = _params(z)
    sort, _ = tmoe.moe_ffn(params, tmoe.MoEConfig(**kw), t["x"])
    with _mesh():
        a2a, _ = tmoe.moe_ffn(params, tmoe.MoEConfig(**kw, dispatch="a2a"),
                              t["x"])
    np.testing.assert_allclose(a2a.numpy(), sort.numpy(), rtol=0,
                               atol=OUT_TOL)


@pytest.mark.parametrize("where", ["no-mesh", "data-only", "decode-s1"])
def test_a2a_without_applicable_model_axis_is_sort_path(where):
    kw = CASES["cf1"]
    z = _inputs(kw)
    params, t = _params(z)
    x = t["x"][:, :1] if where == "decode-s1" else t["x"]
    want = tmoe.moe_ffn(params, tmoe.MoEConfig(**kw), x)
    a2a = tmoe.MoEConfig(**kw, dispatch="a2a")
    if where == "no-mesh":
        got = tmoe.moe_ffn(params, a2a, x)
    elif where == "data-only":
        with use_mesh(make_debug_mesh((2,), ("data",))):
            got = tmoe.moe_ffn(params, a2a, x)
    else:
        with _mesh():
            assert not ta2a.a2a_applicable(a2a, x, current_mesh()[0])
            got = tmoe.moe_ffn(params, a2a, x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_a2a_records_its_collectives_and_slices():
    kw = {**CASES["cf1"], "dispatch": "a2a"}
    cfg = tmoe.MoEConfig(**kw)
    params, t = _params(_inputs(kw))
    shards = LocalShards(4, "cpu")
    seen = []
    real = tmoe.route

    def spy(router, cfg_, tokens, capacity):
        seen.append((tokens.shape[0], capacity))
        return real(router, cfg_, tokens, capacity)

    tmoe.route = spy
    try:
        with use_mesh(make_debug_mesh((2, 4)), shards), \
                shards.recording() as rec:
            tmoe.moe_ffn(params, cfg, t["x"])
    finally:
        tmoe.route = real
    t_loc = (X_SHAPE[0] // 2) * (X_SHAPE[1] // 4)
    # 2 data groups x 4 slices, each with the per-slice capacity
    assert seen == [(t_loc, max(1, int(t_loc * 2 * 1.0 / 8)))] * 8
    kinds = [c.kind for c in rec]
    assert kinds == ["all_to_all", "all_to_all", "psum"] * 2
    cap = seen[0][1]
    assert rec[0].shape == (4, 2, cap, D)  # [dest, E_loc, cap, D] a shard


def test_mesh_must_match_shard_group():
    with pytest.raises(ValueError, match="model axis"):
        with use_mesh(make_debug_mesh((2, 4)), LocalShards(2, "cpu")):
            pass
    assert current_mesh() is None


def test_lm_under_the_mesh_takes_the_a2a_path():
    """The qwen2-moe smoke LM at cf 16: its logits and the gradients of
    its cross-entropy under the mesh equal the sort path's (the aux
    losses differ by design: per-slice fractions), and every MoE layer
    runs two all-to-alls in the forward, two in remat's recompute and
    two in the backward."""
    base = tlm.QWEN2_MOE_SMOKE
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=16.0, dispatch="a2a"))
    model = ttfm.init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 8)))

    def logits_and_grads():
        model.zero_grad()
        logits, _ = model(tokens)
        ttfm.softmax_xent(logits, tokens).backward()
        return logits.detach(), {k: p.grad.clone()
                                 for k, p in model.named_parameters()}

    want, want_g = logits_and_grads()
    shards = LocalShards(4, "cpu")
    with use_mesh(make_debug_mesh((1, 4)), shards), \
            shards.recording() as rec:
        got, got_g = logits_and_grads()
    kinds = [c.kind for c in rec]
    assert kinds.count("all_to_all") == 2 * cfg.n_layers * 3
    assert _rel(got.numpy(), want.numpy()) <= OUT_TOL
    for k, g in want_g.items():
        assert _rel(got_g[k].numpy(), g.numpy()) <= GRAD_TOL, k


# ----------------------------------------------------------- gloo ranks
_RANK = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, init, inp, outp = sys.argv[1:6]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=world)
from repro_torch.core.shards import GroupShards
from repro_torch.distributed.constrain import use_mesh
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import moe as tmoe
z = np.load(inp)
cfg = tmoe.MoEConfig(**json.loads(str(z["cfg"])))
t = {k: torch.from_numpy(z[k].copy()).requires_grad_()
     for k in z.files if k != "cfg"}
L = ("w_gate", "w_up", "w_down")
params = {"router": t["router"],
          "experts": {k: t["experts." + k] for k in L}}
if "shared.w_gate" in t:
    params["shared"] = {k: t["shared." + k] for k in L}
with use_mesh(make_debug_mesh((2, world)), GroupShards()):
    out, aux = tmoe.moe_ffn(params, cfg, t["x"])
    (out.sum() + aux).backward()
res = {"out": out.detach().numpy(), "aux": aux.detach().numpy()}
res.update({"grad." + k: v.grad.numpy() for k, v in t.items()})
np.savez(outp, **res)
dist.destroy_process_group()
print("RANK_OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [2, 4])
def test_group_shards_over_gloo_equal_local_shards(tmp_path, world):
    kw = {**CASES["cf1"], "dispatch": "a2a"}
    z = _inputs(kw, seed=3)
    z["cfg"] = json.dumps(kw)
    np.savez(tmp_path / "in.npz", **z)
    init = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_RANK), str(r), str(world),
         init, str(tmp_path / "in.npz"), str(tmp_path / f"r{r}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        for pr in procs:
            so, se = pr.communicate(timeout=300)
            assert pr.returncode == 0 and "RANK_OK" in so, se[-3000:]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    cfg = tmoe.MoEConfig(**kw)
    params, t = _params(z, grad=True)
    with use_mesh(make_debug_mesh((2, world)), LocalShards(world, "cpu")):
        out, aux = tmoe.moe_ffn(params, cfg, t["x"])
        (out.sum() + aux).backward()
    for r in range(world):
        got = np.load(tmp_path / f"r{r}.npz")
        assert _rel(got["out"], out.detach().numpy()) <= 1e-6
        assert abs(float(got["aux"]) - float(aux.detach())) <= 1e-7
        for k, v in t.items():
            assert _rel(got["grad." + k], v.grad.numpy()) <= 1e-6, (r, k)
