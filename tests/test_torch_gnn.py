"""The port's GatedGCN training path held against the reference: the
synthetic batch (``configs.data.gnn_batch``, byte for byte), the logits,
loss and every gradient of ``repro.models.gnn.gatedgcn`` on the smoke
config and on a narrow config at full depth (16 layers, d_hidden 8, the
1,433 Cora features), with the reference's weights carried across by
``gatedgcn_params_from_numpy``; ``opt_update`` (AdamW and Adafactor) on
the same numpy gradients; ``layernorm`` and ``softmax_xent``; and the
trainer's contract from ``tests/test_train_infra.py`` (checkpoint round
trip and restart at the stored cursor, a wrong config rejected,
retention, the watchdog, the schedule and clipping) and the
``launch.train`` entry point on the CPU.  Inputs are numpy arrays made
from a seed.

Tolerances: the model in float32 through both packages, sums in other
orders (matmuls, the segment sums): |port - ref| <= TOL * (1 + |ref|)
with TOL = 2e-5; the largest differences seen are 8.6e-6 on logits up
to 17 and 1e-6 on gradients.  The optimizer: OPT_TOL = 1e-6 absolute
after three steps (the same float32 operations in the same order; the
gradient norm is summed in another order)."""
from __future__ import annotations

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import data as jdata
from repro.configs import gnn as jgnn
from repro.models import layers as jlayers
from repro.models.gnn import gatedgcn as jgat
from repro.train import optimizer as jopt
from repro_torch.configs import data as tdata
from repro_torch.configs import gnn as tgnn
from repro_torch.configs.registry import ARCH_MODULES, arch_module
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import gatedgcn_params_from_numpy
from repro_torch.models.gnn import gatedgcn as tgat
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import Trainer

torch.set_num_threads(1)

TOL = 2e-5
OPT_TOL = 1e-6

# (reference config, nodes, undirected edges)
CONFIGS = {
    "gatedgcn-smoke": (jgnn.GATEDGCN_SMOKE, 64, 256),
    "gatedgcn-16-layers-d8": (
        dataclasses.replace(jgnn.GATEDGCN, name="gatedgcn-d8", d_hidden=8),
        128, 512),
}
BATCH_FIELDS = ("src", "dst", "node_feat", "labels", "label_mask",
                "graph_id")


def _port_cfg(jcfg) -> tgat.GatedGCNConfig:
    return tgat.GatedGCNConfig(**dataclasses.asdict(jcfg))


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert (err <= tol * (1 + np.abs(want))).all(), float(err.max())


@dataclasses.dataclass
class Run:
    jbatch: object
    tbatch: GraphBatch
    logits_ref: np.ndarray
    loss_ref: float
    grads_ref: dict
    model: tgat.GatedGCN
    logits: torch.Tensor
    loss: torch.Tensor


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def run(request) -> Run:
    jcfg, n, e = CONFIGS[request.param]
    tcfg = _port_cfg(jcfg)
    params = jgat.init_params(jax.random.key(0), jcfg)
    jb = jdata.gnn_batch("gatedgcn", jcfg, n_nodes=n, n_edges_und=e,
                         d_feat=jcfg.d_in, seed=0)
    tb = tdata.gnn_batch("gatedgcn", tcfg, n_nodes=n, n_edges_und=e,
                         d_feat=tcfg.d_in, seed=0, device="cpu")
    loss_ref, grads_ref = jax.value_and_grad(
        lambda p: jgat.loss_fn(jcfg, p, jb))(params)
    model = gatedgcn_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), "cpu")
    logits = model(tb)
    loss = tgat.loss_fn(model, tb)
    loss.backward()
    return Run(jb, tb, np.asarray(jgat.forward(jcfg, params, jb)),
               float(loss_ref), jax.tree.map(np.asarray, grads_ref), model,
               logits.detach(), loss.detach())


def test_batch_is_byte_identical(run):
    assert run.tbatch.n_nodes == run.jbatch.n_nodes
    assert run.tbatch.n_edges == run.jbatch.n_edges
    for name in BATCH_FIELDS:
        want = np.asarray(getattr(run.jbatch, name))
        got = getattr(run.tbatch, name).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name
    # padded slots carry the sentinel n at both ends
    n = run.tbatch.n_nodes
    pad = run.tbatch.dst == n
    assert pad.any() and bool((run.tbatch.src[pad] == n).all())


def test_logits_and_loss_match(run):
    _close(run.logits.numpy(), run.logits_ref)
    _close(run.loss.numpy(), run.loss_ref)
    assert bool(torch.isfinite(run.logits).all())


@pytest.mark.parametrize("leaf", ("embed_h", "embed_e", "readout")
                         + tgat.LAYER_LEAVES)
def test_gradients_match(run, leaf):
    if leaf in tgat.LAYER_LEAVES:
        got = np.stack([getattr(lp, leaf).grad.numpy()
                        for lp in run.model.layers])
        want = run.grads_ref["layers"][leaf]
    else:
        got = getattr(run.model, leaf).grad.numpy()
        want = run.grads_ref[leaf]
    assert np.abs(want).max() > 0
    _close(got, want)


def test_forward_shares_one_layout_across_its_aggregations(monkeypatch):
    cfg = _port_cfg(jgnn.GATEDGCN_SMOKE)
    model = tgat.init_params(cfg, 0, "cpu")
    batch = tdata.gnn_batch("gatedgcn", cfg, n_nodes=40, n_edges_und=100,
                            d_feat=cfg.d_in, device="cpu")
    layouts = []
    real = tgat.segment_sum

    def spy(msgs, seg, n, *, layout):
        layouts.append(layout)
        return real(msgs, seg, n, layout=layout)

    monkeypatch.setattr(tgat, "segment_sum", spy)
    model(batch)
    assert len(layouts) == 2 * cfg.n_layers
    assert all(lay is layouts[0] for lay in layouts)
    # the padded slots' sentinel n is dropped from every sum
    assert int(layouts[0].offsets[-1]) == int((batch.dst < 40).sum())


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_opt_update_matches_the_reference(kind):
    cfg = topt.OptConfig(kind=kind, lr=1e-2, warmup=2, total_steps=6)
    jcfg = jopt.OptConfig(**dataclasses.asdict(cfg))
    jparams = jgat.init_params(jax.random.key(0), jgnn.GATEDGCN_SMOKE)
    flat, tdef = jax.tree_util.tree_flatten_with_path(jparams)
    names = [jax.tree_util.keystr(p) for p, _ in flat]
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in zip(
        names, jax.tree.leaves(jparams))}
    jstate = jopt.opt_init(jcfg, jparams)
    tstate = topt.opt_init(cfg, tparams)
    rng = np.random.default_rng(7)
    # clipped (norm >> 1), unclipped and clipped again
    for scale in (1.0, 1e-3, 0.5):
        g = [(rng.standard_normal(p.shape) * scale).astype(np.float32)
             for p in jax.tree.leaves(jparams)]
        jparams, jstate, jgn = jopt.opt_update(
            jcfg, tdef.unflatten([jnp.asarray(x) for x in g]), jstate,
            jparams)
        _, tstate, tgn = topt.opt_update(
            cfg, {k: torch.from_numpy(x) for k, x in zip(names, g)}, tstate,
            tparams)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-6)
    assert tstate["count"] == int(jstate["count"]) == 3
    for k, want in zip(names, jax.tree.leaves(jparams)):
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(want),
                                   rtol=0, atol=OPT_TOL)
    jflat = {jax.tree_util.keystr(p): np.asarray(v)
             for p, v in jax.tree_util.tree_flatten_with_path(
                 {k: v for k, v in jstate.items() if k != "count"})[0]}
    tflat = {}
    for part, tree in tstate.items():
        if part == "count":
            continue
        for k, v in tree.items():
            if isinstance(v, dict):
                tflat.update({f"['{part}']{k}['{s}']": t
                              for s, t in v.items()})
            else:
                tflat[f"['{part}']{k}"] = v
    assert set(tflat) == set(jflat)
    for k, v in tflat.items():
        np.testing.assert_allclose(v.numpy(), jflat[k], rtol=1e-5,
                                   atol=OPT_TOL, err_msg=k)


def test_layernorm_and_softmax_xent_match():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 5, 70)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(70).astype(np.float32)
    b = rng.standard_normal(70).astype(np.float32)
    got = tlayers.layernorm(*(torch.from_numpy(a) for a in (x, w, b)))
    _close(got.numpy(), jlayers.layernorm(x, w, b))
    logits = rng.standard_normal((40, 16)).astype(np.float32) * 4
    labels = rng.integers(-1, 16, 40).astype(np.int32)
    mask = rng.random(40) > 0.3
    for m in (None, mask, np.zeros(40, bool)):
        got = tlayers.softmax_xent(
            torch.from_numpy(logits), torch.from_numpy(labels),
            mask=None if m is None else torch.from_numpy(m))
        _close(got.numpy(), jlayers.softmax_xent(
            jnp.asarray(logits), jnp.asarray(labels),
            mask=None if m is None else jnp.asarray(m)))


def test_configs_equal_the_reference():
    from repro.configs.registry import arch_module as j_arch_module

    mod, jmod = arch_module("gatedgcn"), j_arch_module("gatedgcn")
    for which in ("CONFIG", "SMOKE"):
        assert getattr(mod, which) == _port_cfg(getattr(jmod, which))
    assert mod.SHAPES == jmod.SHAPES == tgnn.GNN_SHAPES
    assert mod.FAMILY == "gnn" and "gatedgcn" in ARCH_MODULES
    assert set(tsteps.GNN_MODULES) == {"gatedgcn", "gat-cora", "schnet",
                                       "dimenet"}


def test_graph_batch_to_device():
    cfg = tgnn.GATEDGCN_SMOKE
    b = tdata.gnn_batch("gatedgcn", cfg, n_nodes=30, n_edges_und=60,
                        d_feat=cfg.d_in, device="cpu")
    c = b.to("cpu")
    assert c.positions is None and c.trip_kj is None
    assert torch.equal(c.node_feat, b.node_feat) and c.n_nodes == 30
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            b.to("cuda")


# ---------------------------------------------------------------- trainer

def _pieces(seed: int = 0):
    cfg = tgnn.GATEDGCN_SMOKE
    model = tgat.init_params(cfg, seed, "cpu")
    batch = tdata.gnn_batch("gatedgcn", cfg, n_nodes=48, n_edges_und=160,
                            d_feat=cfg.d_in, seed=1, device="cpu")
    return cfg, model, (lambda m, b: tgat.loss_fn(m, b)), batch


def test_checkpoint_roundtrip_and_restart(tmp_path):
    cfg, model, loss, batch = _pieces()
    opt_cfg = topt.OptConfig(lr=1e-3, warmup=1, total_steps=20)
    tr = Trainer(loss, model, opt_cfg, ckpt_dir=tmp_path, cfg=cfg,
                 ckpt_every=3, log_every=100)
    rep = tr.fit(ttrain.FixedStream(batch), 5)
    assert ckpt.latest_step(tmp_path) == 5 and len(rep["step_seconds"]) == 5
    # a crash and relaunch: a fresh trainer on other weights restores the
    # step, the cursor, the weights and the optimizer state
    _, other, _, _ = _pieces(seed=1)
    tr2 = Trainer(loss, other, opt_cfg, ckpt_dir=tmp_path, cfg=cfg,
                  log_every=100)
    assert tr2.maybe_restore()
    assert tr2.step_num == 5 and tr2.cursor == 5
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), k
    assert tr2.opt_state["count"] == 5
    for k, v in tr.opt_state["mu"].items():
        assert torch.equal(v, tr2.opt_state["mu"][k])
    # continue training from the restored state, at the stored cursor
    stream = ttrain.FixedStream(batch)
    tr2.fit(stream, 2)
    assert tr2.step_num == 7 and stream.cursor == 7


def test_checkpoint_rejects_wrong_config(tmp_path):
    cfg, model, _, _ = _pieces()
    params = dict(model.named_parameters())
    state = {"params": params, "opt": topt.opt_init(topt.OptConfig(),
                                                    params)}
    ckpt.save(tmp_path, 1, state, cfg=cfg)
    with pytest.raises(ValueError, match="different config"):
        ckpt.load(tmp_path, state, cfg="other-config")
    restored, manifest = ckpt.load(tmp_path, state, cfg=cfg)
    assert manifest["step"] == 1 and restored["opt"]["count"] == 0
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.load(tmp_path, {"params": {**params, "readout": torch.zeros(3)},
                             "opt": state["opt"]})


def test_checkpoint_retention(tmp_path):
    _, model, _, _ = _pieces()
    for step in range(1, 6):
        ckpt.save(tmp_path, step, {"p": model.state_dict()}, keep=2)
    files = sorted(pathlib.Path(tmp_path).glob("step_*.npz"))
    assert len(files) == 2
    assert files[-1].name == "step_00000005.npz"


def test_watchdog_raises():
    _, model, loss, batch = _pieces()
    tr = Trainer(loss, model, topt.OptConfig(), watchdog_s=0.0,
                 log_every=100)
    with pytest.raises(TimeoutError):
        tr.fit(ttrain.FixedStream(batch), 1)


def test_adafactor_memory_is_sublinear_and_moves_params():
    _, model, loss, batch = _pieces()
    params = dict(model.named_parameters())
    size = lambda t: sum(size(v) for v in t.values()) if isinstance(
        t, dict) else (t.numel() if isinstance(t, torch.Tensor) else 0)
    adam = topt.opt_init(topt.OptConfig(kind="adamw"), params)
    fac = topt.opt_init(topt.OptConfig(kind="adafactor"), params)
    assert size(fac) < 0.5 * size(adam)
    before = {k: p.detach().clone() for k, p in params.items()}
    step = tsteps.make_train_step(loss, topt.OptConfig(kind="adafactor"))
    fac, metrics = step(model, fac, batch)
    assert float(metrics["grad_norm"]) > 0 and fac["count"] == 1
    assert max(float((p.detach() - before[k]).abs().max())
               for k, p in params.items()) > 0


def test_schedule_and_clip():
    oc = topt.OptConfig(lr=1.0, warmup=10, total_steps=110)
    assert topt.schedule(oc, 5) == pytest.approx(0.5)
    assert topt.schedule(oc, 10) == pytest.approx(1.0)
    assert topt.schedule(oc, 110) == pytest.approx(0.0, abs=1e-6)
    jc = jopt.OptConfig(lr=1.0, warmup=10, total_steps=110)
    for s in (1, 37, 64, 200):
        assert topt.schedule(oc, s) == float(jopt.schedule(jc, jnp.int32(s)))
    g = {"a": torch.full((3,), 100.0)}
    clipped, gn = topt.clip_by_global_norm(g, 1.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(
        1.0, rel=1e-5)
    assert float(gn) == pytest.approx(100 * 3 ** 0.5, rel=1e-6)


# ------------------------------------------------------------- entry point

def test_train_main_runs_on_the_cpu(tmp_path):
    report = ttrain.main(["--arch", "gatedgcn", "--smoke", "--steps", "3",
                          "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert report["steps"] == 3 and len(report["history"]) == 3
    assert np.isfinite(report["history"]).all()
    assert ckpt.latest_step(tmp_path) == 3
    # a relaunch with every step done resumes and has nothing to do
    assert ttrain.main(["--arch", "gatedgcn", "--smoke", "--steps", "3",
                        "--device", "cpu", "--ckpt-dir",
                        str(tmp_path)]) is None


def test_train_main_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--arch", "gatedgcn", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgat.init_params(tgnn.GATEDGCN_SMOKE)


@pytest.mark.parametrize("arch", ["smollm-135m", "bst", "qwen2-moe-a2.7b",
                                  "not-an-arch"])
def test_train_main_refuses_what_is_not_ported(arch):
    """Every architecture of the reference is ported: the LMs (dense and
    MoE) and BST train on the CPU; only a name the registry does not
    know is refused."""
    argv = ["--arch", arch, "--smoke", "--steps", "1", "--device", "cpu"]
    if arch == "not-an-arch":
        with pytest.raises(KeyError, match="unknown --arch"):
            ttrain.main(argv)
        return
    report = ttrain.main(argv + ["--batch", "2", "--seq", "8"])
    assert report["steps"] == 1 and np.isfinite(report["history"]).all()


def _fail_once(monkeypatch, at_step: int) -> dict:
    """Make the first step that starts at ``step_num == at_step`` run and
    then raise, as a crash after the step's in-place update would."""
    state = {"failed": False}
    real_init = Trainer.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        step = self._step

        def flaky(*args):
            out = step(*args)
            if not state["failed"] and self.step_num == at_step:
                state["failed"] = True
                raise RuntimeError("injected step failure")
            return out

        self._step = flaky

    monkeypatch.setattr(Trainer, "__init__", init)
    return state


def _final_params(ckpt_dir) -> dict:
    step = ckpt.latest_step(ckpt_dir)
    with np.load(pathlib.Path(ckpt_dir) / f"step_{step:08d}.npz") as f:
        return {k: f[k] for k in f.files if k.startswith("params/")}


@pytest.mark.parametrize("at_step", [1, 4], ids=["before-ckpt",
                                                 "after-ckpt"])
def test_relaunch_after_a_step_failure_equals_a_clean_run(tmp_path,
                                                          monkeypatch,
                                                          at_step):
    """A step fails once (its update already applied); the relaunch
    restarts from the initial weights when no checkpoint exists yet
    (step 1; checkpoints every 3 steps) and resumes from the checkpoint
    when one does (step 4).  Either way the final weights and loss equal
    a clean run's, bit for bit."""
    argv = ["--arch", "gatedgcn", "--smoke", "--steps", "6", "--device",
            "cpu", "--ckpt-every", "3", "--ckpt-dir"]
    clean = ttrain.main(argv + [str(tmp_path / "clean")])
    state = _fail_once(monkeypatch, at_step)
    again = ttrain.main(argv + [str(tmp_path / "relaunched")])
    assert state["failed"]
    assert again["steps"] == clean["steps"] == 6
    assert again["final_loss"] == clean["final_loss"]
    want = _final_params(tmp_path / "clean")
    got = _final_params(tmp_path / "relaunched")
    assert want.keys() == got.keys() and want
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
