"""The port's LM training path held against ``repro.models.transformer``
on the CPU: ``loss_fn`` and every gradient leaf against
``jax.value_and_grad(repro.models.transformer.loss_fn)`` on the same
weights (carried across by ``lm_params_from_numpy``) and tokens, on the
smollm-135m and gemma3-1b smoke configs and a 2-layer smollm-135m at full
width; ``remat="block"`` against ``"none"``; three AdamW steps through
both packages' ``make_train_step``; ``LMStream`` as a pure function of
``(seed, cursor)``; and ``launch/train.py`` on the CPU with its relaunch
after a step failure.  Inputs are numpy arrays made from a seed.

Tolerances: float32 through both packages, sums in other orders (the
matmuls, the softmax, K5's plain backward against XLA's autodiff): the
loss within LOSS_TOL * (1 + |ref|), each gradient leaf within
GRAD_TOL * (1 + |ref|) element by element.  The largest gaps seen: the
loss equal in float32 on all three configs, and 4.5e-7 on a leaf (the
2-layer full-width smollm's ``embed``)."""
from __future__ import annotations

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm as jlm
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.train import optimizer as jopt
from repro_torch.configs import data as tdata
from repro_torch.configs import lm as tlm
from repro_torch.kernels.flash_attention import flash_attention as tkern
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.data import LMStream
from repro_torch.train.trainer import Trainer

torch.set_num_threads(1)

LOSS_TOL = 2e-5
GRAD_TOL = 1e-4
# three AdamW steps at lr 1e-3: the same arithmetic on gradients that
# agree to GRAD_TOL, so the weights agree to OPT_TOL (absolute) but for
# the entries whose gradient is near 0, where Adam's normalised step
# m / sqrt(v) turns a float32 gap into a part of lr: at most OPT_FRACTION
# of the elements, each within OPT_MAX (5 % of lr).  Seen: 14 of 344,736
# elements past 1e-6 (smollm smoke), the largest 2.3e-5.
OPT_TOL = 1e-6
OPT_FRACTION = 1e-4
OPT_MAX = 5e-5

CONFIGS = {
    "smollm-135m-smoke": jlm.SMOLLM_135M_SMOKE,
    "gemma3-1b-smoke": jlm.GEMMA3_1B_SMOKE,
    "smollm-135m-2layer-full-width": dataclasses.replace(jlm.SMOLLM_135M,
                                                         n_layers=2),
}
B, S = 2, 12


def port_cfg(jcfg) -> ttfm.LMConfig:
    """The port's ``LMConfig`` of a reference config (its MoE config too)."""
    names = {f.name for f in dataclasses.fields(ttfm.LMConfig)}
    kw = {n: getattr(jcfg, n) for n in names}
    if jcfg.moe is not None:
        kw["moe"] = tmoe.MoEConfig(**dataclasses.asdict(jcfg.moe))
    return ttfm.LMConfig(**kw)


def ref_leaf(tree: dict, name: str) -> np.ndarray:
    """The reference tree's leaf of a port parameter name
    (``layers.3.moe.experts.w_up`` -> ``tree["layers"]["moe"]
    ["experts"]["w_up"][3]``)."""
    parts = name.split(".")
    if parts[0] != "layers":
        return np.asarray(tree[parts[0]])
    leaf = tree["layers"]
    for p in parts[2:]:
        leaf = leaf[p]
    return np.asarray(leaf[int(parts[1])])


def tokens_labels(vocab: int, seed: int = 0, b: int = B, s: int = S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _gap(got, want) -> float:
    return float((np.abs(got - want) / (1 + np.abs(want))).max())


@dataclasses.dataclass
class Grads:
    loss_ref: float
    loss: float
    gaps: dict      # parameter name -> largest scaled gap
    names: set      # the port's parameter names
    ref_names: set  # the reference's leaves, as port names


def _ref_names(tree, prefix="") -> set:
    out = set()
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _ref_names(v, f"{prefix}{k}.")
        elif prefix.startswith("layers."):
            rest = prefix[len("layers."):]
            out |= {f"layers.{i}.{rest}{k}" for i in range(v.shape[0])}
        else:
            out.add(f"{prefix}{k}")
    return out


def value_and_grads(jcfg, seed: int = 0) -> Grads:
    params = jtfm.init_params(jax.random.key(seed), jcfg)
    tok, lab = tokens_labels(jcfg.vocab, seed)
    loss_ref, grads_ref = jax.value_and_grad(lambda p: jtfm.loss_fn(
        jcfg, p, jnp.asarray(tok), jnp.asarray(lab)))(params)
    grads_ref = jax.tree.map(np.asarray, grads_ref)
    model = lm_params_from_numpy(port_cfg(jcfg),
                                 jax.tree.map(np.asarray, params), "cpu")
    loss = ttfm.loss_fn(model, torch.from_numpy(tok), torch.from_numpy(lab))
    loss.backward()
    gaps = {name: _gap(p.grad.numpy(), ref_leaf(grads_ref, name))
            for name, p in model.named_parameters()}
    return Grads(float(loss_ref), float(loss), gaps,
                 {n for n, _ in model.named_parameters()},
                 _ref_names(grads_ref))


@pytest.fixture(scope="module", params=list(CONFIGS))
def grads(request) -> Grads:
    return value_and_grads(CONFIGS[request.param])


def test_loss_equals_the_reference(grads):
    assert abs(grads.loss - grads.loss_ref) <= LOSS_TOL * (
        1 + abs(grads.loss_ref))


def test_every_gradient_leaf_equals_the_reference(grads):
    assert grads.names == grads.ref_names
    worst = max(grads.gaps, key=grads.gaps.get)
    assert grads.gaps[worst] <= GRAD_TOL, (worst, grads.gaps[worst])


@pytest.mark.parametrize("arch", ["smollm-135m-smoke", "gemma3-1b-smoke",
                                  "qwen2-moe-smoke"])
def test_remat_block_gives_the_gradients_of_none(arch):
    jcfg = {"qwen2-moe-smoke": jlm.QWEN2_MOE_SMOKE,
            **CONFIGS}[arch]
    params = jax.tree.map(np.asarray,
                          jtfm.init_params(jax.random.key(1), jcfg))
    tok, lab = (torch.from_numpy(x) for x in tokens_labels(jcfg.vocab, 1))
    out = {}
    for remat in ("block", "none"):
        cfg = dataclasses.replace(port_cfg(jcfg), remat=remat)
        model = lm_params_from_numpy(cfg, params, "cpu")
        loss = ttfm.loss_fn(model, tok, lab)
        loss.backward()
        out[remat] = (loss.detach(), {n: p.grad for n, p in
                                      model.named_parameters()})
    assert torch.equal(out["block"][0], out["none"][0])
    for name, g in out["none"][1].items():
        assert torch.equal(out["block"][1][name], g), name


def test_remat_block_runs_each_layers_attention_forward_twice():
    cfg = tlm.SMOLLM_135M_SMOKE
    model = ttfm.init_params(cfg, seed=0, device="cpu")
    calls = []
    real = tkern.FlashAttention.forward

    def spy(ctx, *args):
        calls.append(1)
        return real(ctx, *args)

    tkern.FlashAttention.forward = staticmethod(spy)
    try:
        tok, lab = (torch.from_numpy(x) for x in tokens_labels(cfg.vocab))
        ttfm.loss_fn(model, tok, lab).backward()
    finally:
        tkern.FlashAttention.forward = staticmethod(real)
    assert len(calls) == 2 * cfg.n_layers


@pytest.mark.parametrize("arch", ["smollm-135m-smoke", "qwen2-moe-smoke"])
def test_three_adamw_steps_equal_the_reference(arch):
    jcfg = {"smollm-135m-smoke": jlm.SMOLLM_135M_SMOKE,
            "qwen2-moe-smoke": jlm.QWEN2_MOE_SMOKE}[arch]
    ocfg = topt.OptConfig(kind="adamw", lr=1e-3, warmup=2, total_steps=6)
    params = jtfm.init_params(jax.random.key(2), jcfg)
    model = lm_params_from_numpy(port_cfg(jcfg),
                                 jax.tree.map(np.asarray, params), "cpu")
    jocfg = jopt.OptConfig(**dataclasses.asdict(ocfg))
    jstep = jax.jit(jsteps.lm_train_step(jcfg, jocfg))
    tstep = tsteps.lm_train_step(port_cfg(jcfg), ocfg)
    jstate = jopt.opt_init(jocfg, params)
    tstate = topt.opt_init(ocfg, dict(model.named_parameters()))
    for i in range(3):
        tok, lab = tokens_labels(jcfg.vocab, seed=10 + i)
        params, jstate, jm = jstep(params, jstate, jnp.asarray(tok),
                                   jnp.asarray(lab))
        tstate, tm = tstep(model, tstate, torch.from_numpy(tok),
                           torch.from_numpy(lab))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL * (
            1 + abs(float(jm["loss"])))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert tstate["count"] == 3
    tree = jax.tree.map(np.asarray, params)
    past, total = 0, 0
    for name, p in model.named_parameters():
        gap = np.abs(p.detach().numpy() - ref_leaf(tree, name))
        assert gap.max() <= OPT_MAX, (name, gap.max())
        past += int((gap > OPT_TOL).sum())
        total += gap.size
    assert past <= OPT_FRACTION * total, (past, total)


# ------------------------------------------------------------- data


def test_lm_stream_is_a_pure_function_of_seed_and_cursor():
    cfg = tlm.SMOLLM_135M_SMOKE
    first = LMStream(cfg, 3, 9, seed=5, device="cpu")
    batches = [next(first) for _ in range(4)]
    assert first.cursor == 4
    resumed = LMStream(cfg, 3, 9, seed=5, cursor=2, device="cpu")
    for want in batches[2:]:
        got = next(resumed)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    tok, lab = batches[1]
    assert tok.shape == lab.shape == (3, 9) and tok.dtype == torch.int64
    assert torch.equal(tok[:, 1:], lab[:, :-1])
    assert 0 <= int(tok.min()) and int(tok.max()) < cfg.vocab
    want = tdata.lm_batch(cfg, 3, 9, 5, cursor=1, device="cpu")
    assert all(torch.equal(g, w) for g, w in zip(batches[1], want))
    other = next(LMStream(cfg, 3, 9, seed=6, device="cpu"))
    assert not torch.equal(other[0], batches[0][0])
    assert not torch.equal(batches[0][0], batches[1][0])


def test_trainer_restart_resumes_the_stream_at_its_cursor(tmp_path):
    cfg = tlm.SMOLLM_135M_SMOKE
    ocfg = topt.OptConfig(lr=1e-3, warmup=1, total_steps=4)
    model = ttfm.init_params(cfg, seed=0, device="cpu")
    seen = []

    def loss(m, tok, lab):
        seen.append(tok.clone())
        return ttfm.loss_fn(m, tok, lab)

    tr = Trainer(loss, model, ocfg, ckpt_dir=str(tmp_path), cfg=cfg,
                 ckpt_every=2)
    tr.fit(LMStream(cfg, 2, 8, seed=3, device="cpu"), 2)
    again = Trainer(loss, ttfm.init_params(cfg, seed=9, device="cpu"), ocfg,
                    ckpt_dir=str(tmp_path), cfg=cfg)
    assert again.maybe_restore() and again.cursor == 2
    again.fit(LMStream(cfg, 2, 8, seed=3, device="cpu"), 1)
    want = tdata.lm_batch(cfg, 2, 8, 3, cursor=2, device="cpu")[0]
    assert torch.equal(seen[-1], want)


# ------------------------------------------------------------- entry point


def test_train_main_trains_smollm_on_the_cpu(tmp_path):
    report = ttrain.main(["--arch", "smollm-135m", "--smoke", "--steps", "3",
                          "--batch", "2", "--seq", "16", "--device", "cpu",
                          "--ckpt-dir", str(tmp_path)])
    assert report["steps"] == 3 and len(report["history"]) == 3
    assert np.isfinite(report["history"]).all()
    assert ckpt.latest_step(tmp_path) == 3


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
    restarts from the initial weights when no checkpoint exists yet and
    resumes from the checkpoint (weights, optimizer state and the
    stream's cursor) when one does.  Either way the final weights and
    loss equal a clean run's, bit for bit."""
    argv = ["--arch", "smollm-135m", "--smoke", "--steps", "6", "--batch",
            "2", "--seq", "8", "--device", "cpu", "--ckpt-every", "3",
            "--ckpt-dir"]
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


def test_train_main_still_refuses_bst():
    """BST trains now (``--batch`` users a step); the one family that
    trains nothing, ``cover-edge-tc``'s ``tc``, exits as the reference's
    entry point does."""
    report = ttrain.main(["--arch", "bst", "--smoke", "--steps", "1",
                          "--batch", "8", "--device", "cpu"])
    assert report["steps"] == 1 and np.isfinite(report["history"]).all()
    with pytest.raises(SystemExit, match="not trainable"):
        ttrain.main(["--arch", "cover-edge-tc", "--smoke", "--steps", "1",
                     "--device", "cpu"])
