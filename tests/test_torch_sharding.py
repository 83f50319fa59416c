"""``repro_torch.distributed`` (sharding rules, ``clean_axis``, the
ambient mesh) and ``repro_torch.launch.mesh`` held against
``repro.distributed`` and ``repro.launch.mesh`` on the CPU.

Every parameter rule is compared leaf by leaf on each family's smoke
parameters: the port's parameters by name (``launch/steps.py:
shape_model``, on the ``meta`` device), each mapped to its reference leaf
by ``models/convert.py:reference_leaf``; a stacked reference leaf's spec
is the port's with a leading None.  The batch and cache rules are
compared on the production layouts, ``lm_cache_spec`` on both sides of
``batch >= ndev``.  The reference's rules read only ``mesh.shape``, so
they get a stand-in with the layout's shape (no forced devices)."""
from __future__ import annotations

import types

import jax
import pytest
import torch

from repro.configs import registry as jreg
from repro.distributed import constrain as jcon
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps
from repro.train.optimizer import OptConfig as JOptConfig, opt_init as jinit
from repro_torch.configs import registry as treg
from repro_torch.distributed import constrain as tcon
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models.convert import reference_leaf
from repro_torch.train.optimizer import OptConfig, opt_init

LAYOUTS = {
    "pod": tmesh.make_production_mesh(),
    "multipod": tmesh.make_production_mesh(multi_pod=True),
    "debug": tmesh.make_debug_mesh((2, 4)),
    "data-only": tmesh.make_debug_mesh((4,), ("data",)),
}
FAMILY_RULES = {
    "lm": (jsh.lm_param_specs, tsh.lm_param_specs),
    "gnn": (jsh.gnn_param_specs, tsh.gnn_param_specs),
    "recsys": (jsh.bst_param_specs, tsh.bst_param_specs),
}


def _stand_in(layout):
    return types.SimpleNamespace(shape=layout.shape)


def _norm(spec, ndim: int) -> list:
    """A spec as one tuple of axis names a dimension, padded to ``ndim``."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        out.append(() if e is None else (e,) if isinstance(e, str)
                   else tuple(e))
    return out


def _ref_leaves(arch: str, cfg) -> dict:
    """The reference's smoke parameter shapes and specs by key path."""
    mod = jreg.arch_module(arch)
    params = jax.eval_shape(
        lambda: jsteps.init_for(arch, cfg, jax.random.key(0)))
    rule = FAMILY_RULES[mod.FAMILY][0]
    specs = rule(params, _stand_in(LAYOUTS["pod"]))
    flat_p = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_s = jax.tree_util.tree_flatten(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    out = {}
    for (path, leaf), spec in zip(flat_p, flat_s, strict=True):
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        out[key] = (leaf.shape, spec)
    return out


@pytest.mark.parametrize("arch", treg.ASSIGNED_ARCHS)
def test_param_rules_equal_reference_leaf_by_leaf(arch):
    mod = treg.arch_module(arch)
    ref = _ref_leaves(arch, jreg.arch_module(arch).SMOKE)
    model = tsteps.shape_model(arch, mod.SMOKE)
    params = dict(model.named_parameters())
    specs = FAMILY_RULES[mod.FAMILY][1](params, LAYOUTS["pod"])
    assert set(specs) == set(params)
    seen = set()
    for name, leaf in params.items():
        path, index = reference_leaf(model, name)
        shape, rspec = ref[path]
        want = _norm(rspec, len(shape))
        if index is not None:  # stacked: the leading L is never sharded
            assert want[0] == () and 0 <= index < shape[0], name
            want, shape = want[1:], shape[1:]
        assert tuple(leaf.shape) == tuple(shape), name
        assert _norm(specs[name], leaf.dim()) == want, name
        assert len(specs[name]) == leaf.dim(), name  # full-length specs
        seen.add(path)
    assert seen == set(ref)  # every reference leaf has a port parameter


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_batch_rules_equal_reference(layout):
    lay = LAYOUTS[layout]
    m = _stand_in(lay)
    assert tsh.data_axes(lay) == jsh.data_axes(m)
    assert tsh.flat_axes(lay) == jsh.flat_axes(m)
    pairs = [(tsh.lm_batch_specs(lay, k), jsh.lm_batch_specs(m, k))
             for k in ("train", "prefill")]
    pairs += [(tsh.bst_batch_specs(lay, k), jsh.bst_batch_specs(m, k))
              for k in ("train", "serve", "retrieval")]
    pairs.append((tsh.gnn_batch_specs(lay), jsh.gnn_batch_specs(m)))
    for got, want in pairs:
        assert set(got) == set(want)
        for k in got:
            assert _norm(got[k], 2) == _norm(want[k], 2), k
    with pytest.raises(ValueError):
        tsh.lm_batch_specs(lay, "decode")


@pytest.mark.parametrize("batch", [1, 15, 16, 32, 128])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_lm_cache_spec_both_sides_of_ndev(layout, batch):
    lay = LAYOUTS[layout]
    got = tsh.lm_cache_spec(lay, batch)
    want = jsh.lm_cache_spec(_stand_in(lay), batch)
    assert _norm(got, 5) == _norm(want, 5)


def test_lm_cache_spec_switches_at_ndev():
    pod = LAYOUTS["multipod"]  # 32 data ways
    assert tsh.lm_cache_spec(pod, 32)[1] == ("pod", "data")
    assert tsh.lm_cache_spec(pod, 31)[1] is None
    assert tsh.lm_cache_spec(pod, 31)[2] == ("pod", "data", "model")


def test_opt_state_specs_mirror_params():
    model = tsteps.shape_model("smollm-135m", treg.arch_module(
        "smollm-135m").SMOKE)
    params = dict(model.named_parameters())
    pspecs = tsh.lm_param_specs(params, LAYOUTS["pod"])
    for kind in ("adamw", "adafactor"):
        opt = opt_init(OptConfig(kind=kind), params)
        specs = tsh.opt_state_specs(pspecs, opt)
        assert specs["count"] is None  # a host int (the reference: P())
        if kind == "adamw":
            assert specs["mu"] is pspecs and specs["nu"] is pspecs
        else:
            assert all(v == () for sub in specs["v"].values()
                       for v in sub.values())
    # the reference's: mu / nu mirror, the int32 count replicated
    jp = jax.eval_shape(lambda: jsteps.init_for(
        "smollm-135m", jreg.arch_module("smollm-135m").SMOKE,
        jax.random.key(0)))
    jps = jsh.lm_param_specs(jp, None)
    jspecs = jsh.opt_state_specs(jps, jax.eval_shape(
        lambda: jinit(JOptConfig(), jp)))
    assert jspecs["mu"] is jps and jspecs["count"] == jax.sharding.\
        PartitionSpec()


AXES = [None, "data", "model", "pod", ("pod", "data"), ("pod",),
        ("model", "data"), ["data", "pod"], (), ("x",), "x"]


@pytest.mark.parametrize("names", [("data", "model"),
                                   ("pod", "data", "model"), ("p",), ()])
def test_clean_axis_equals_reference(names):
    for ax in AXES:
        assert tcon.clean_axis(ax, names) == jcon._clean_axis(ax, names)


def test_maybe_constrain_is_identity_and_mesh_scoped():
    x = torch.arange(6.0).reshape(2, 3)
    assert tcon.maybe_constrain(x, "model", None) is x
    assert tcon.current_mesh() is None
    lay = LAYOUTS["debug"]
    with tcon.use_mesh(lay) as got:
        assert got is lay and tcon.current_mesh() == (lay, None)
        assert tcon.maybe_constrain(x, "model", ("pod", "data")) is x
        with tcon.use_mesh(LAYOUTS["pod"]):
            assert tcon.current_mesh()[0] is LAYOUTS["pod"]
        assert tcon.current_mesh()[0] is lay
    assert tcon.current_mesh() is None


def test_shard_shape():
    lay = LAYOUTS["multipod"]
    assert tsh.shard_shape((64, 32), ("model", None), lay) == (4, 32)
    assert tsh.shard_shape((64, 32), (("pod", "data"),), lay) == (2, 32)
    assert tsh.shard_shape((7, 3), (), lay) == (7, 3)
    assert tsh.shard_shape((), (), lay) == ()
    with pytest.raises(ValueError, match="does not divide"):
        tsh.shard_shape((60, 8), ("model", None), lay)  # 60 on 16
    with pytest.raises(ValueError, match="does not divide"):
        tsh.shard_shape((8, 48), (None, ("pod", "data", "model")), lay)
    with pytest.raises(ValueError, match="not in the layout"):
        tsh.shard_shape((16,), ("p",), lay)
    with pytest.raises(ValueError, match="more entries"):
        tsh.shard_shape((16,), (None, None), lay)


def test_layouts():
    pod, multi = LAYOUTS["pod"], LAYOUTS["multipod"]
    assert pod.shape == {"data": 16, "model": 16} and pod.size == 256
    assert multi.axes == ("pod", "data", "model") and multi.size == 512
    dbg = tmesh.make_debug_mesh()
    assert dbg.shape == {"data": 1, "model": 1} and dbg.size == 1
    tc = tmesh.make_tc_mesh(4, "cpu")
    assert tc.p == 4 and tc.device.type == "cpu"
    with pytest.raises(ValueError):
        tmesh.MeshLayout(("a", "a"), (1, 2))
    with pytest.raises(ValueError):
        tmesh.MeshLayout(("a",), (1, 2))
