"""The port's recsys BST held against the reference
(``repro.models.recsys.bst``) at ``BST_SMOKE``, on the reference's
weights carried across by ``models/convert.py:bst_params_from_numpy``
and on the same numpy batch: the logits, the loss, every leaf's
gradient, one AdamW step through ``launch/steps.py:bst_train_step`` and
``score_candidates``; ``graph/segment.py:embedding_bag`` against the
reference's in every mode, with and without weights; ``BSTStream``; the
configs and the registry; ``launch/train.py --arch bst`` and
``--arch cover-edge-tc`` on the CPU; and the ``cover-edge-tc`` config's
graph counted on the local and the distributed route.  Inputs are numpy
arrays made from a seed.

Tolerances: ``embedding_bag`` within 1e-6 (1 + |ref|) (one float32 sum
of at most a few rows in another order); the model within 1e-4 (1 +
|ref|) (float32 matmuls, softmax and LayerNorm in other orders); one
AdamW step: the reference's ``opt_update`` on the port's own gradients
equals the port's step to OPT_TOL = 1e-6 (the same float32
operations)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.api import TriangleEngine as JEngine
from repro.configs import recsys as jrecsys
from repro.configs import registry as jreg
from repro.graph import segment as jseg
from repro.launch import steps as jsteps
from repro.models.recsys import bst as jbst
from repro.train import optimizer as jopt
from repro_torch.api import TriangleEngine
from repro_torch.configs import data as tdata
from repro_torch.configs import recsys as trecsys
from repro_torch.configs import registry as treg
from repro_torch.core.shards import LocalShards
from repro_torch.graph import segment as tseg
from repro_torch.kernels.segsum import segsum as tsegk
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import convert
from repro_torch.models.recsys import bst as tbst
from repro_torch.train import data as tdatastream
from repro_torch.train import optimizer as topt
from tests import oracle

torch.set_num_threads(1)

EB_TOL = 1e-6
TOL = 1e-4
OPT_TOL = 1e-6
JCFG, TCFG = jrecsys.BST_SMOKE, trecsys.BST_SMOKE


def _close(got, want, tol) -> float:
    """Asserts |got - want| <= tol * (1 + |want|); returns the largest
    |got - want| / (1 + |want|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scaled = float((np.abs(got - want) / (1 + np.abs(want))).max(initial=0))
    assert scaled <= tol, scaled
    return scaled


def _np_batch(cfg, b: int, seed: int = 0):
    """``(history, target, profile_idx, profile_bag, labels)`` as numpy:
    int32 ids, the reference's bag layout and Bernoulli(0.3) labels."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, cfg.item_vocab, (b, cfg.seq_len - 1)).astype(np.int32)
    t = rng.integers(0, cfg.item_vocab, (b,)).astype(np.int32)
    pi = rng.integers(0, cfg.profile_vocab,
                      (b * cfg.profile_bag,)).astype(np.int32)
    pb = np.repeat(np.arange(b, dtype=np.int32), cfg.profile_bag)
    y = (rng.random(b) < 0.3).astype(np.float32)
    return h, t, pi, pb, y


def _t(arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _ref_leaf(tree, name):
    """The reference tree's leaf for the port's parameter ``name``."""
    parts = name.split(".")
    if parts[0] == "blocks":          # blocks.{i}.{leaf} -> blocks[i][leaf]
        return tree["blocks"][int(parts[1])][parts[2]]
    if parts[0] == "mlp":
        return tree["mlp"][parts[1]]
    return tree[parts[0]]


# ---------------------------------------------------------- embedding_bag

def _bag_case(seed: int, weighted: bool):
    """A table of 50 rows, 300 lookups into 40 bags: indices past both
    ends (clipped), bag ids -1 and >= 40 (dropped), bag 7 empty."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((50, 6)).astype(np.float32)
    idx = rng.integers(-5, 56, 300).astype(np.int32)
    bags = rng.integers(-1, 43, 300).astype(np.int32)
    bags[bags == 7] = 40
    w = rng.standard_normal(300).astype(np.float32) if weighted else None
    return table, idx, bags, w


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_the_reference(mode, weighted):
    table, idx, bags, w = _bag_case(3, weighted)
    want = np.asarray(jseg.embedding_bag(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(bags), 40,
        mode=mode, weights=None if w is None else jnp.asarray(w)))
    got = tseg.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(idx),
        torch.from_numpy(bags), 40, mode=mode,
        weights=None if w is None else torch.from_numpy(w)).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == (40, 6)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    _close(got[finite], want[finite], EB_TOL)
    # the empty bag: 0 for a sum or a mean, -inf for a max
    assert (got[7] == (-np.inf if mode == "max" else 0.0)).all()


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_equals_torch_embedding_bag_in_range(mode):
    """In-range lookups into non-empty bags, as ``F.embedding_bag`` takes
    them (offsets of a sorted bag list): the same bags, as a yardstick."""
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 64, 200))
    bags = torch.from_numpy(np.sort(rng.integers(0, 30, 200)))
    bags[:30] = torch.arange(30)          # every bag holds a lookup
    bags, _ = bags.sort()
    offsets = torch.searchsorted(bags, torch.arange(30))
    want = F.embedding_bag(idx, table, offsets, mode=mode)
    got = tseg.embedding_bag(table, idx, bags, 30, mode=mode)
    _close(got.numpy(), want.numpy(), EB_TOL)


def test_embedding_bag_sum_goes_through_the_segment_sum_entry(monkeypatch):
    """The bag sum is ``kernels/segsum/ops.py:segment_sum`` (K4 on the
    card); on the CPU it launches nothing, and the gradient reaches the
    table as the gather's backward."""
    calls = []
    real = tseg.segops.segment_sum

    def spy(msgs, seg, n, **kw):
        calls.append((tuple(msgs.shape), n))
        return real(msgs, seg, n, **kw)

    monkeypatch.setattr(tseg.segops, "segment_sum", spy)
    table, idx, bags, _ = _bag_case(4, False)
    tab = torch.from_numpy(table).requires_grad_()
    before = tsegk.LAUNCHES["segment_sum"]
    out = tseg.embedding_bag(tab, torch.from_numpy(idx),
                             torch.from_numpy(bags), 40)
    out.sum().backward()
    assert calls == [((300, 6), 40)]
    assert tsegk.LAUNCHES["segment_sum"] == before
    # each table row's gradient counts its kept lookups
    keep = (bags >= 0) & (bags < 40)
    want = np.bincount(np.clip(idx, 0, 49)[keep], minlength=50)
    np.testing.assert_array_equal(tab.grad.numpy(),
                                  np.repeat(want[:, None], 6, 1))
    with pytest.raises(ValueError, match="unknown mode"):
        tseg.embedding_bag(tab, torch.from_numpy(idx),
                           torch.from_numpy(bags), 40, mode="median")


# ------------------------------------------------------------------- BST

@dataclasses.dataclass
class Run:
    params: dict
    grads_ref: dict
    logits_ref: np.ndarray
    loss_ref: float
    model: tbst.BST
    logits: torch.Tensor
    loss: torch.Tensor
    batch: tuple


@pytest.fixture(scope="module")
def run() -> Run:
    params = jbst.init_params(jax.random.key(0), JCFG)
    batch = _np_batch(JCFG, 24)
    loss_ref, grads = jax.value_and_grad(
        lambda p: jbst.loss_fn(JCFG, p, *batch))(params)
    model = convert.bst_params_from_numpy(
        TCFG, jax.tree.map(np.asarray, params), "cpu")
    tb = _t(batch)
    logits = model(*tb[:4])
    loss = tbst.loss_fn(model, *tb)
    loss.backward()
    return Run(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray,
                                                              grads),
               np.asarray(jbst.forward(JCFG, params, *batch[:4])),
               float(loss_ref), model, logits.detach(), loss.detach(), batch)


def test_forward_and_loss_match(run):
    assert run.logits.shape == (24,) and bool(torch.isfinite(run.logits).all())
    _close(run.logits.numpy(), run.logits_ref, TOL)
    _close(run.loss.numpy(), run.loss_ref, TOL)


LEAVES = (list(tbst.TOP_LEAVES)
          + [f"blocks.0.{leaf}" for leaf in tbst.BLOCK_LEAVES]
          + [f"mlp.{k}{i}" for k in "wb" for i in range(len(TCFG.mlp_dims)
                                                        + 1)])


@pytest.mark.parametrize("leaf", LEAVES)
def test_gradients_match(run, leaf):
    params = dict(run.model.named_parameters())
    assert set(params) == set(LEAVES)
    want = _ref_leaf(run.grads_ref, leaf)
    got = params[leaf].grad.numpy()
    print(f"{leaf}: {_close(got, want, TOL):.3g}")
    assert np.abs(want).max() > 0


def test_one_adamw_step_matches_the_reference():
    """``bst_train_step`` (forward, backward, AdamW) against the
    reference's ``opt_update`` applied to the port's own gradients from
    the same weights: the update equal to OPT_TOL; the loss and the
    gradient norm against the reference's step within TOL."""
    params = jax.tree.map(np.asarray, jbst.init_params(jax.random.key(1),
                                                       JCFG))
    batch = _np_batch(JCFG, 32, seed=1)
    opt_cfg = topt.OptConfig(lr=1e-3, warmup=1, total_steps=10)
    jcfg_opt = jopt.OptConfig(**dataclasses.asdict(opt_cfg))
    model = convert.bst_params_from_numpy(TCFG, params, "cpu")
    state = topt.opt_init(opt_cfg, dict(model.named_parameters()))
    state, metrics = tsteps.bst_train_step(TCFG, opt_cfg)(model, state,
                                                          *_t(batch))

    jparams = jax.tree.map(jnp.asarray, params)
    jstep = jax.jit(jsteps.bst_train_step(JCFG, jcfg_opt))
    _, _, jm = jstep(jparams, jopt.opt_init(jcfg_opt, jparams), *batch)
    _close(float(metrics["loss"]), float(jm["loss"]), TOL)
    _close(float(metrics["grad_norm"]), float(jm["grad_norm"]), TOL)

    port_grads = jax.tree.map(np.zeros_like, params)
    for name, p in model.named_parameters():
        _ref_leaf(port_grads, name)[...] = p.grad.numpy()
    want, _, _ = jopt.opt_update(
        jcfg_opt, jax.tree.map(jnp.asarray, port_grads),
        jopt.opt_init(jcfg_opt, jparams), jparams)
    want = jax.tree.map(np.asarray, want)
    moved = 0.0
    for name, p in model.named_parameters():
        ref = _ref_leaf(want, name)
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=0,
                                   atol=OPT_TOL, err_msg=name)
        moved = max(moved, float(np.abs(ref - _ref_leaf(params,
                                                        name)).max()))
    assert moved > 1e-4  # the step moved the weights


def test_score_candidates_matches_the_reference_and_forward(run):
    """Target-aware retrieval: the reference's scores, and ``forward``
    on the same (history, candidate) rows with every profile lookup
    dropped (a zero profile vector)."""
    rng = np.random.default_rng(7)
    hist = run.batch[0][3]
    cands = rng.integers(0, JCFG.item_vocab, 40).astype(np.int32)
    want = np.asarray(jbst.score_candidates(JCFG, run.params, hist, cands))
    step = tsteps.bst_retrieval_step(TCFG)
    got = step(run.model, torch.from_numpy(hist), torch.from_numpy(cands))
    assert not got.requires_grad
    _close(got.numpy(), want, TOL)
    c = len(cands)
    hists = torch.from_numpy(np.repeat(hist[None], c, 0))
    dropped = torch.full((c * TCFG.profile_bag,), c)     # every bag empty
    with torch.no_grad():
        fwd = run.model(hists, torch.from_numpy(cands),
                        torch.zeros(c * TCFG.profile_bag, dtype=torch.long),
                        dropped)
    _close(got.numpy(), fwd.numpy(), 1e-6)


@pytest.mark.parametrize("chunk", [1, 7, 40, 1000])
def test_score_candidates_in_chunks_equals_one_call(run, chunk, monkeypatch):
    """Retrieval in slices of ``RETRIEVAL_SLICE`` scores every candidate
    once, in order, as one call does; equal to float32 rounding (the
    CPU's GEMM picks its blocking by the row count, so the bits may
    differ)."""
    rng = np.random.default_rng(8)
    hist = torch.from_numpy(run.batch[0][0])
    cands = torch.from_numpy(rng.integers(0, JCFG.item_vocab, 40))
    assert tbst.RETRIEVAL_SLICE >= 40
    one = tsteps.bst_retrieval_step(TCFG)(run.model, hist, cands)
    monkeypatch.setattr(tbst, "RETRIEVAL_SLICE", chunk)
    got = tsteps.bst_retrieval_step(TCFG)(run.model, hist, cands)
    assert got.shape == one.shape == (40,)
    _close(got.numpy(), one.numpy(), 1e-6)


def test_serve_step_equals_forward_without_gradients(run):
    tb = _t(run.batch)
    got = tsteps.bst_serve_step(TCFG)(run.model, *tb[:4])
    assert not got.requires_grad
    torch.testing.assert_close(got, run.logits, rtol=0, atol=0)


def test_converter_checks_the_tree(run):
    tree = dict(run.params, blocks=run.params["blocks"] * 2)
    with pytest.raises(ValueError, match="blocks"):
        convert.bst_params_from_numpy(TCFG, tree, "cpu")
    tree = dict(run.params, mlp={**run.params["mlp"], "w9": 0})
    with pytest.raises(ValueError, match="mlp"):
        convert.bst_params_from_numpy(TCFG, tree, "cpu")


def test_init_params_is_seeded_and_shaped_as_the_reference():
    a = tsteps.init_for("bst", TCFG, 3, "cpu").state_dict()
    b = tsteps.init_for("bst", TCFG, 3, "cpu").state_dict()
    c = tsteps.init_for("bst", TCFG, 4, "cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    ref = jax.eval_shape(lambda: jbst.init_params(jax.random.key(0), JCFG))
    for k, v in a.items():
        assert tuple(v.shape) == _ref_leaf(ref, k).shape, k
    # the reference's initialisers: ones and zeros where it puts them
    for k, v in a.items():
        if k.endswith(("_b",)) or k.startswith("mlp.b"):
            assert not v.any(), k
        if k.endswith("_w"):
            assert (v == 1).all(), k
    assert 0.015 < float(a["item_embed"].std()) < 0.025      # 0.02 normal


# ------------------------------------------------------- data and configs

def test_bst_batch_and_stream_are_pure_functions_of_the_cursor():
    cfg = TCFG
    a = tdata.bst_batch(cfg, 512, 3, cursor=5, device="cpu")
    b = tdata.bst_batch(cfg, 512, 3, cursor=5, device="cpu")
    c = tdata.bst_batch(cfg, 512, 3, cursor=6, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    h, t, pi, pb, y = a
    assert h.shape == (512, cfg.seq_len - 1) and t.shape == (512,)
    assert pi.shape == pb.shape == (512 * cfg.profile_bag,)
    assert int(h.min()) >= 0 and int(h.max()) < cfg.item_vocab
    assert int(pi.min()) >= 0 and int(pi.max()) < cfg.profile_vocab
    np.testing.assert_array_equal(
        pb.numpy(), np.repeat(np.arange(512), cfg.profile_bag))
    assert y.dtype == torch.float32 and set(y.unique().tolist()) <= {0., 1.}
    assert 0.2 < float(y.mean()) < 0.4                  # Bernoulli(0.3)
    stream = tdatastream.BSTStream(cfg, 512, seed=3, device="cpu")
    first = [next(stream) for _ in range(7)]
    assert stream.cursor == 7
    assert all(torch.equal(x, y) for x, y in zip(first[5], a))
    again = tdatastream.BSTStream(cfg, 512, seed=3, cursor=5, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(next(again), a))


@pytest.mark.parametrize("arch", ["bst", "cover-edge-tc"])
def test_configs_equal_the_reference(arch):
    mod, jmod = treg.arch_module(arch), jreg.arch_module(arch)
    assert mod.FAMILY == jmod.FAMILY
    assert mod.SHAPES == jmod.SHAPES
    for which in ("CONFIG", "SMOKE"):
        got, want = getattr(mod, which), getattr(jmod, which)
        if arch == "bst":
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want
    assert mod.__name__ == jmod.__name__.replace("repro.", "repro_torch.", 1)
    assert set(treg.ARCH_MODULES) == set(jreg.ARCH_MODULES)


def test_recsys_shapes_equal_the_reference():
    assert trecsys.RECSYS_SHAPES == jrecsys.RECSYS_SHAPES
    assert dataclasses.asdict(trecsys.BST) == dataclasses.asdict(jrecsys.BST)


# ------------------------------------------------------------ entry points

def test_train_main_trains_bst_on_the_cpu(capsys):
    """The labels are Bernoulli(0.3) draws independent of the inputs, so
    the loss falls towards their entropy (0.611) and no further; a batch
    of 256 keeps the steps' noise below the fall."""
    report = ttrain.main(["--arch", "bst", "--smoke", "--steps", "30",
                          "--batch", "256", "--lr", "1e-3", "--device",
                          "cpu"])
    hist = report["history"]
    assert report["steps"] == 30 and np.isfinite(hist).all()
    assert np.mean(hist[-10:]) < np.mean(hist[:5]) - 0.02
    out = capsys.readouterr().out
    assert "bst: " in out and "done: 30 steps" in out


def test_train_main_bst_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--arch", "bst", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbst.init_params(TCFG)


def test_train_main_exits_on_cover_edge_tc():
    with pytest.raises(SystemExit, match="not trainable \\(family tc\\)"):
        ttrain.main(["--arch", "cover-edge-tc", "--smoke", "--device",
                     "cpu"])
    with pytest.raises(ValueError, match="tc family has no weights"):
        tsteps.init_for("cover-edge-tc", {}, device="cpu")


def test_cover_edge_tc_counts_rmat_smoke():
    """``rmat_smoke`` (scale 10, edge factor 16) through the distributed
    route with the config's options (ring mode over 8 stacked shards)
    equals the local count, the reference's integers and the oracle."""
    mod = treg.arch_module("cover-edge-tc")
    edges, n = mod.shape_graph("rmat_smoke")
    opts = mod.options()
    assert opts.mode == "ring" and opts.hedge_chunk == 4096
    eng = TriangleEngine(device="cpu", mesh=LocalShards(8, "cpu"))
    dist = eng.count((edges, n), route="distributed", options=opts)
    local = eng.count((edges, n), route="local")
    want = JEngine().count((edges, n))
    assert dist.plan_id == "hedge/ring/p8" and not dist.overflow.hedge
    assert dist.triangles == local.triangles == want.triangles
    assert (local.c1, local.c2) == (want.c1, want.c2)
    assert dist.num_horizontal == local.num_horizontal == want.num_horizontal
    assert local.triangles == oracle.total_triangles(edges, n) == 75682
    assert int(dist.per_device.sum()) == dist.triangles
