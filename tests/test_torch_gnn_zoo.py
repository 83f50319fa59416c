"""The port's GAT, SchNet and DimeNet held against the reference
(``repro.models.gnn.{gat,schnet,dimenet}``) at their smoke configs, on
the reference's weights carried across by ``models/convert.py`` and on
``gnn_batch(n_nodes=60, n_edges_und=180)`` (the molecular nets at
``n_graphs=4``, as ``tests/test_arch_smoke.py`` runs them): the batch
byte for byte, the logits or energies, the loss, every leaf's gradient,
and one AdamW step; the K4 calls of a forward (4, 4 and 8, each model's
layouts shared); ``edge_vectors`` and the special functions; the
configs, the registry, the FLOP formulas and the ``launch.train`` entry
point on the CPU.  Inputs are numpy arrays made from a seed.

Tolerances: float32 through both packages, matmuls and sums in other
orders: |port - ref| <= TOL * (1 + |ref|), TOL = 2e-5 (the GatedGCN
tests'), DimeNet at 1e-4: its energies sum 240 atoms' edge messages
and its gradients reach 6e3, so a float32 sum's rounding, measured
against each element's (1 + |ref|), came to 1.9e-5 on ``w_edge_in``'s
gradient at one thread, at the edge of 2e-5.  One AdamW step: the
reference's ``opt_update`` on the port's own gradients equals the
port's step to OPT_TOL = 1e-6 (the same float32 operations)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import data as jdata
from repro.configs import gnn as jgnn
from repro.configs import registry as jreg
from repro.models.gnn import common as jcommon
from repro.models.gnn import dimenet as jdimenet
from repro.models.gnn import gat as jgat
from repro.models.gnn import schnet as jschnet
from repro.train import optimizer as jopt
from repro_torch.configs import data as tdata
from repro_torch.configs import gnn as tgnn
from repro_torch.configs import registry as treg
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import convert
from repro_torch.models.gnn import common as tcommon
from repro_torch.models.gnn import dimenet as tdimenet
from repro_torch.models.gnn import gat as tgat
from repro_torch.models.gnn import schnet as tschnet
from repro_torch.train import optimizer as topt

torch.set_num_threads(1)

TOL = {"gat-cora": 2e-5, "schnet": 2e-5, "dimenet": 1e-4}
OPT_TOL = 1e-6

# arch -> (reference module, port module, reference smoke config, port
# smoke config, converter, n_graphs, K4 calls a forward at the smoke depth)
ARCHS = {
    "gat-cora": (jgat, tgat, jgnn.GAT_CORA_SMOKE, tgnn.GAT_CORA_SMOKE,
                 convert.gat_params_from_numpy, 1, 2 * 2),
    "schnet": (jschnet, tschnet, jgnn.SCHNET_SMOKE, tgnn.SCHNET_SMOKE,
               convert.schnet_params_from_numpy, 4, 2 + 1),
    "dimenet": (jdimenet, tdimenet, jgnn.DIMENET_SMOKE, tgnn.DIMENET_SMOKE,
                convert.dimenet_params_from_numpy, 4, 2 + 2),
}
BATCH_FIELDS = ("src", "dst", "node_feat", "positions", "atom_type",
                "graph_id", "labels", "label_mask", "trip_kj", "trip_ji")


def _close(got, want, tol) -> float:
    """Asserts |got - want| <= tol * (1 + |want|); returns the largest
    |got - want| / (1 + |want|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scaled = float((np.abs(got - want) / (1 + np.abs(want))).max(initial=0))
    assert scaled <= tol, scaled
    return scaled


def _batch_kw(arch):
    cfg = ARCHS[arch][2]
    return dict(n_nodes=60, n_edges_und=180, d_feat=getattr(cfg, "d_in", 8),
                n_graphs=ARCHS[arch][5])


def _ref_leaf(arch, tree, name):
    """The reference tree's leaf for the port's parameter ``name``."""
    parts = name.split(".")
    if arch == "gat-cora":            # layers.{i}.{leaf} -> {leaf}{i}
        return tree[f"{parts[2]}{parts[1]}"]
    if parts[0] == "blocks":          # blocks.{i}.{leaf} -> blocks/leaf[i]
        return tree["blocks"][parts[2]][int(parts[1])]
    return tree[parts[0]]


@dataclasses.dataclass
class Run:
    jbatch: object
    tbatch: tcommon.GraphBatch
    out_ref: np.ndarray
    loss_ref: float
    params_ref: dict
    grads_ref: dict
    model: torch.nn.Module
    out: torch.Tensor
    loss: torch.Tensor


def _make_run(arch) -> Run:
    jm, tm, jcfg, tcfg, conv, _, _ = ARCHS[arch]
    jb = jdata.gnn_batch(arch, jcfg, seed=0, **_batch_kw(arch))
    tb = tdata.gnn_batch(arch, tcfg, seed=0, device="cpu", **_batch_kw(arch))
    params = jm.init_params(jax.random.key(0), jcfg)
    loss_ref, grads_ref = jax.value_and_grad(
        lambda p: jm.loss_fn(jcfg, p, jb))(params)
    model = conv(tcfg, jax.tree.map(np.asarray, params), "cpu")
    out = model(tb)
    loss = tm.loss_fn(model, tb)
    loss.backward()
    return Run(jb, tb, np.asarray(jm.forward(jcfg, params, jb)),
               float(loss_ref), jax.tree.map(np.asarray, params),
               jax.tree.map(np.asarray, grads_ref), model, out.detach(),
               loss.detach())


@pytest.fixture(scope="module")
def runs():
    """arch -> its ``Run``, made on first use and kept for the module."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _make_run(arch)
        return cache[arch]

    return get


@pytest.fixture(params=sorted(ARCHS))
def run(request, runs) -> Run:
    return runs(request.param)


def _arch(run):
    return run.model.cfg.name.removesuffix("-smoke")


def test_batch_is_byte_identical(run):
    assert run.tbatch.n_nodes == run.jbatch.n_nodes
    assert run.tbatch.n_edges == run.jbatch.n_edges
    for name in BATCH_FIELDS:
        want = getattr(run.jbatch, name)
        got = getattr(run.tbatch, name)
        if want is None:
            assert got is None, name
            continue
        want = np.asarray(want)
        got = got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name


def test_outputs_and_loss_match(run):
    tol = TOL[_arch(run)]
    assert bool(torch.isfinite(run.out).all())
    _close(run.out.numpy(), run.out_ref, tol)
    _close(run.loss.numpy(), run.loss_ref, tol)


LEAVES = sorted(
    [("gat-cora", f"layers.{i}.{leaf}") for i in range(2)
     for leaf in tgat.LAYER_LEAVES]
    + [("schnet", name) for name in tschnet.TOP_LEAVES]
    + [("schnet", f"blocks.*.{name}") for name in tschnet.BLOCK_LEAVES]
    + [("dimenet", name) for name in tdimenet.TOP_LEAVES]
    + [("dimenet", f"blocks.*.{name}") for name in tdimenet.BLOCK_LEAVES])


@pytest.mark.parametrize("arch,leaf", LEAVES,
                         ids=[f"{a}-{leaf}" for a, leaf in LEAVES])
def test_gradients_match(runs, arch, leaf):
    run = runs(arch)
    params = dict(run.model.named_parameters())
    names = ([leaf.replace("*", str(i)) for i in range(len(run.model.blocks))]
             if "*" in leaf else [leaf])
    for name in names:
        want = _ref_leaf(arch, run.grads_ref, name)
        got = params[name].grad.numpy()
        # the largest gap, for the record (pytest -s shows it)
        print(f"{name}: {_close(got, want, TOL[arch]):.3g}")
    assert any(np.abs(_ref_leaf(arch, run.grads_ref, n)).max() > 0
               for n in names)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_one_adamw_step_matches_the_reference(arch):
    """The port's train step (forward, backward, AdamW) against the
    reference's ``opt_update`` applied to the port's own gradients from
    the same weights: the update equal to OPT_TOL; the loss and the
    gradient norm against the reference's step within TOL."""
    jm, tm, jcfg, tcfg, conv, _, _ = ARCHS[arch]
    jb = jdata.gnn_batch(arch, jcfg, seed=1, **_batch_kw(arch))
    tb = tdata.gnn_batch(arch, tcfg, seed=1, device="cpu", **_batch_kw(arch))
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.key(1),
                                                     jcfg))
    opt_cfg = topt.OptConfig(lr=1e-3, warmup=1, total_steps=10)
    jcfg_opt = jopt.OptConfig(**dataclasses.asdict(opt_cfg))
    model = conv(tcfg, params, "cpu")
    state = topt.opt_init(opt_cfg, dict(model.named_parameters()))
    step = tsteps.gnn_train_step(arch, tcfg, opt_cfg)
    state, metrics = step(model, state, tb)

    jparams = jax.tree.map(jnp.asarray, params)
    jstep = jax.jit(lambda p, o, b: jopt.opt_update(
        jcfg_opt, jax.grad(lambda q: jm.loss_fn(jcfg, q, b))(p), o, p))
    _, _, jgn = jstep(jparams, jopt.opt_init(jcfg_opt, jparams), jb)
    jloss = jm.loss_fn(jcfg, jparams, jb)
    _close(float(metrics["loss"]), float(jloss), TOL[arch])
    _close(float(metrics["grad_norm"]), float(jgn), TOL[arch])

    # the port's gradients through the reference's update
    port_grads = jax.tree.map(np.zeros_like, params)
    for name, p in model.named_parameters():
        _ref_leaf(arch, port_grads, name)[...] = p.grad.numpy()
    want, _, _ = jopt.opt_update(
        jcfg_opt, jax.tree.map(jnp.asarray, port_grads),
        jopt.opt_init(jcfg_opt, jparams), jparams)
    want = jax.tree.map(np.asarray, want)
    moved = 0.0
    for name, p in model.named_parameters():
        ref = _ref_leaf(arch, want, name)
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=0,
                                   atol=OPT_TOL, err_msg=name)
        moved = max(moved, float(np.abs(ref - _ref_leaf(arch, params,
                                                         name)).max()))
    assert moved > 1e-4  # the step moved the weights


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_k4_calls_share_their_layouts(arch, monkeypatch):
    """Every segment sum of a forward goes through
    ``kernels.segsum.ops.segment_sum`` (K4 on the card): GAT's 2 per
    layer over one destination layout; SchNet's one per block over one
    layout and the readout; DimeNet's one per block over one triplet
    layout and its two readouts.  On the CPU none launches K4."""
    from repro_torch.graph import segment as tseg
    from repro_torch.kernels.segsum import segsum as tsegk

    jm, tm, jcfg, tcfg, conv, _, want = ARCHS[arch]
    model = tm.init_params(tcfg, 0, "cpu")
    batch = tdata.gnn_batch(arch, tcfg, seed=0, device="cpu",
                            **_batch_kw(arch))
    calls = []
    real = tm.segment_sum

    def spy(msgs, seg, n, *, layout=None):
        calls.append((msgs.shape, layout))
        return real(msgs, seg, n, layout=layout)

    monkeypatch.setattr(tm, "segment_sum", spy)
    monkeypatch.setattr(tcommon, "segment_sum", spy)
    monkeypatch.setattr(tseg.segops, "segment_sum", spy)
    before = tsegk.LAUNCHES["segment_sum"]
    model(batch)
    assert tsegk.LAUNCHES["segment_sum"] == before
    assert len(calls) == want
    n, e = batch.n_nodes, batch.n_edges
    if arch == "gat-cora":
        lays = {id(lay) for _, lay in calls}
        assert len(lays) == 1
        f = [shape[1] for shape, _ in calls]
        cfg = tcfg
        assert f == [cfg.n_heads, cfg.n_heads * cfg.d_hidden, 1,
                     cfg.n_classes]
    else:
        blocks = calls[:-1] if arch == "schnet" else calls[:-2]
        assert len({id(lay) for _, lay in blocks}) == 1
        assert blocks[0][1].num_segments == (n if arch == "schnet" else e)
        assert calls[-1][0] == (n, 1)   # the per-graph readout as [N, 1]
    assert all(shape[0] in (n, e, batch.trip_kj.shape[0]
                            if batch.trip_kj is not None else e)
               for shape, _ in calls)


# ------------------------------------------------------ geometry and bases

def test_edge_vectors_equal_the_reference():
    kw = dict(_batch_kw("schnet"), n_edges_und=1000)  # padded slots too
    jb = jdata.gnn_batch("schnet", jgnn.SCHNET_SMOKE, **kw)
    tb = tdata.gnn_batch("schnet", tgnn.SCHNET_SMOKE, device="cpu", **kw)
    want = [np.asarray(a) for a in jcommon.edge_vectors(jb)]
    got = [a.numpy() for a in tcommon.edge_vectors(tb)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(got[2], want[2])
    assert (~got[2]).any() and (got[1][~got[2]] == 1.0).all()
    _close(got[0], want[0], 1e-6)
    _close(got[1], want[1], 1e-6)


def test_schnet_centres_equal_the_reference_bit_for_bit():
    """The registry's widths carry the reference's own centres; any
    other width takes jnp.linspace's formula, within 2 ulp of it."""
    for num in (300, 20):
        got = tschnet.rbf_centres(num, 10.0).numpy()
        want = np.asarray(jnp.linspace(0.0, 10.0, num))
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()
        assert tschnet.SchNet(dataclasses.replace(
            tgnn.SCHNET_SMOKE, n_rbf=num)).centers.numpy().tobytes() == \
            want.tobytes()
    for num, stop in ((7, 3.5), (50, 1.0), (300, 10.0)):
        got = tschnet.linspace(0.0, stop, num).numpy()
        want = np.asarray(jnp.linspace(0.0, stop, num))
        assert got[0] == want[0] == 0 and got[-1] == want[-1] == stop
        assert np.abs(got.view(np.int32) - want.view(np.int32)).max() <= 2
    assert tschnet.rbf_centres(7, 3.5).numpy().tobytes() == \
        tschnet.linspace(0.0, 3.5, 7).numpy().tobytes()


@pytest.mark.parametrize("fn", ["shifted_softplus", "rbf_expand",
                                "bessel_rbf", "angular_basis"])
def test_special_functions_match(fn):
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.uniform(-30, 30, 200), [0.0, 20.0, 25.0, -1.0,
                                                    1.0, 1e-6]]
                       ).astype(np.float32)
    dist = np.abs(x) / 2
    if fn == "shifted_softplus":
        got, want = tschnet.shifted_softplus(torch.from_numpy(x)), \
            jschnet.shifted_softplus(jnp.asarray(x))
    elif fn == "rbf_expand":
        got, want = tschnet.rbf_expand(torch.from_numpy(dist),
                                       tschnet.rbf_centres(300, 10.0), 10.0), \
            jschnet.rbf_expand(jnp.asarray(dist), 300, 10.0)
    elif fn == "bessel_rbf":
        got, want = tdimenet.bessel_rbf(torch.from_numpy(dist), 6, 10.0), \
            jdimenet.bessel_rbf(jnp.asarray(dist), 6, 10.0)
    else:
        c = np.clip(x / 30, -1, 1).astype(np.float32)
        c[:3] = [-1.0, 1.0, 0.0]
        got, want = tdimenet.angular_basis(torch.from_numpy(c), 7), \
            jdimenet.angular_basis(jnp.asarray(c), 7)
    assert got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want), 2e-6)


# ------------------------------------------------ configs and entry point

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_equal_the_reference(arch):
    mod, jmod = treg.arch_module(arch), jreg.arch_module(arch)
    for which in ("CONFIG", "SMOKE"):
        got, want = getattr(mod, which), getattr(jmod, which)
        assert type(got).__name__ == type(want).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert mod.SHAPES == jmod.SHAPES
    assert mod.FAMILY == jmod.FAMILY == "gnn"
    assert tsteps.GNN_MODULES[arch] is ARCHS[arch][1]
    assert mod.__name__ == jmod.__name__.replace("repro.", "repro_torch.", 1)


@pytest.mark.parametrize("arch", ["gatedgcn"] + sorted(ARCHS))
def test_fwd_flops_equal_the_reference(arch):
    jcfg = jreg.arch_module(arch).CONFIG
    cfg = treg.arch_module(arch).CONFIG
    for n, e, t in ((2708, 21112, 0), (3840, 16384, 131072),
                    (169984, 168960, 0)):
        extra = (t,) if arch == "dimenet" else ()
        got = treg.GNN_FWD_FLOPS[arch](cfg, n, e, *extra)
        assert got == jreg._GNN_FWD_FLOPS[arch](jcfg, n, e, *extra) > 0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_params_is_seeded_and_the_same_on_each_call(arch):
    cfg = ARCHS[arch][3]
    a = tsteps.init_for(arch, cfg, 3, "cpu").state_dict()
    b = tsteps.init_for(arch, cfg, 3, "cpu").state_dict()
    c = tsteps.init_for(arch, cfg, 4, "cpu").state_dict()
    assert set(a) == set(b) == set(c)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    # the reference's initialisers: zeros where it puts zeros
    zeros = {"gat-cora": ("a_dst",), "schnet": ("_b1", "_b2"),
             "dimenet": ()}[arch]
    for k, v in a.items():
        if k.endswith(zeros) and zeros:
            assert not v.any(), k


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_main_runs_each_arch_on_the_cpu(arch, capsys):
    report = ttrain.main(["--arch", arch, "--smoke", "--steps", "2",
                          "--gnn-nodes", "64", "--gnn-edges", "160",
                          "--device", "cpu"])
    assert report["steps"] == 2 and np.isfinite(report["history"]).all()
    assert "done: 2 steps" in capsys.readouterr().out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_main_needs_the_card_by_default(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--arch", arch, "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ARCHS[arch][1].init_params(ARCHS[arch][3])
