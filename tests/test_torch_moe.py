"""The port's MoE layers held against ``repro.models.moe`` and the MoE
transformer against ``repro.models.transformer`` on the CPU, on the
QWEN2_MOE_SMOKE (shared experts) and PHI35_MOE_SMOKE (GQA) configs:
the routing integers (each entry's expert, its place in the stable sort,
its position inside its expert and whether it is kept) bit for bit
against the reference's own steps; ``moe_ffn``'s output, aux loss and
gradients; a padded case (``pad_experts_to`` > ``n_experts``); a forced
small ``capacity`` that drops entries (a decode step's capacity of 1
among them); the transformer's ``forward``, ``prefill`` and
``decode_step``; one training step; and the converter's MoE leaves.
Inputs are numpy arrays made from a seed.

Tolerances (float32 through both packages, sums in other orders; the
combine is a segment sum in another order): outputs and the aux loss
within TOL * (1 + |ref|), gradients within GRAD_TOL * (1 + |ref|).  The
routing is exact unless two probabilities tie to float32 rounding: each
case logs the smallest gap between an entry's k-th and (k+1)-th
probability, and none of these inputs comes near."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm as jlm
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch.configs import lm as tlm
from repro_torch.configs.registry import arch_module
from repro_torch.kernels.segsum import segsum as tk4
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.train import optimizer as topt

torch.set_num_threads(1)

TOL = 2e-5
GRAD_TOL = 1e-4
#: a gradient entry clear of 0 for Adam's first step (see the training
#: step's test)
G_MIN = 1e-6

# name -> (reference LM config, capacity override or None)
CASES = {
    "qwen2-moe-smoke": (jlm.QWEN2_MOE_SMOKE, None),
    "phi3.5-moe-smoke": (jlm.PHI35_MOE_SMOKE, None),
    "qwen2-moe-padded": (dataclasses.replace(
        jlm.QWEN2_MOE_SMOKE, moe=dataclasses.replace(
            jlm.QWEN2_MOE_SMOKE.moe, pad_experts_to=12)), None),
    "qwen2-moe-capacity-2": (jlm.QWEN2_MOE_SMOKE, 2),
    "phi3.5-moe-capacity-1": (jlm.PHI35_MOE_SMOKE, 1),
}
B, S = 2, 12


def port_moe(jmoe_cfg) -> tmoe.MoEConfig:
    return tmoe.MoEConfig(**dataclasses.asdict(jmoe_cfg))


def port_cfg(jcfg) -> ttfm.LMConfig:
    names = {f.name for f in dataclasses.fields(ttfm.LMConfig)}
    kw = {n: getattr(jcfg, n) for n in names}
    kw["moe"] = port_moe(jcfg.moe)
    return ttfm.LMConfig(**kw)


def jax_routing(params, cfg, tokens, capacity):
    """The reference's routing steps (``repro.models.moe.moe_ffn`` up to
    ``keep``), as it writes them."""
    n_tok = tokens.shape[0]
    e, k = cfg.n_phys, cfg.top_k
    logits = (tokens @ params["router"]).astype(jnp.dtype(cfg.router_dtype))
    if cfg.n_phys > cfg.n_experts:
        logits = jnp.where((jnp.arange(e) >= cfg.n_experts)[None, :], -1e30,
                           logits)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, k)
    flat_expert = expert_idx.reshape(-1)
    flat_token = jnp.broadcast_to(jnp.arange(n_tok)[:, None],
                                  (n_tok, k)).reshape(-1)
    order = jnp.argsort(flat_expert, stable=True)
    se, stok = flat_expert[order], flat_token[order]
    starts = jnp.searchsorted(se, jnp.arange(e)).astype(jnp.int32)
    pos = jnp.arange(n_tok * k, dtype=jnp.int32) - starts[
        jnp.clip(se, 0, e - 1)]
    return dict(probs=np.asarray(probs), expert_idx=np.asarray(expert_idx),
                se=np.asarray(se), stok=np.asarray(stok),
                pos=np.asarray(pos), keep=np.asarray(pos < capacity))


def _tensors(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _tensors(v, grad) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))
    return t.requires_grad_() if grad else t


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    gap = np.abs(got - want) / (1 + np.abs(want))
    assert gap.max() <= tol, gap.max()


@dataclasses.dataclass
class Layer:
    cfg: object            # the reference's MoEConfig
    capacity: int
    params: dict           # the reference's numpy tree
    x: np.ndarray          # [B, S, d]
    cot: np.ndarray        # the output's cotangent


@pytest.fixture(scope="module", params=list(CASES))
def layer(request) -> Layer:
    jcfg, cap = CASES[request.param]
    cfg = jcfg.moe
    params = jax.tree.map(np.asarray, jmoe.moe_ffn_init(
        jax.random.key(3), cfg, jcfg.d_model))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    capacity = cap if cap is not None else tmoe.capacity_for(
        port_moe(cfg), B * S)
    return Layer(cfg, capacity, params, x, cot)


def test_capacity_is_the_reference_formula():
    for jcfg in (jlm.QWEN2_MOE_A2_7B, jlm.PHI35_MOE, jlm.QWEN2_MOE_SMOKE):
        cfg = jcfg.moe
        for n_tok in (4, 16, 128, 8192):
            assert tmoe.capacity_for(port_moe(cfg), n_tok) == max(
                1, int(n_tok * cfg.top_k * cfg.capacity_factor
                       / cfg.n_experts))
    # a decode step of batch 4 on qwen2-moe keeps one entry an expert
    assert tmoe.capacity_for(port_moe(jlm.QWEN2_MOE_A2_7B.moe), 4) == 1


def test_routing_integers_equal_the_reference(layer):
    tokens = layer.x.reshape(B * S, -1)
    want = jax_routing(layer.params, layer.cfg, jnp.asarray(tokens),
                       layer.capacity)
    r = tmoe.route(torch.from_numpy(layer.params["router"]),
                   port_moe(layer.cfg), torch.from_numpy(tokens),
                   layer.capacity)
    top = np.sort(want["probs"], -1)[:, ::-1]
    k = layer.cfg.top_k
    print(f"smallest gap between the k-th and (k+1)-th probability: "
          f"{float((top[:, k - 1] - top[:, k]).min()):.3e}")
    np.testing.assert_array_equal(r.expert_idx.numpy(), want["expert_idx"])
    np.testing.assert_array_equal(r.se.numpy(), want["se"])
    np.testing.assert_array_equal(r.stok.numpy(), want["stok"])
    np.testing.assert_array_equal(r.pos.numpy(), want["pos"])
    np.testing.assert_array_equal(r.keep.numpy(), want["keep"])
    _close(r.probs.numpy(), want["probs"], TOL)
    if layer.cfg.n_phys > layer.cfg.n_experts:
        assert not (r.expert_idx >= layer.cfg.n_experts).any()
        assert float(r.probs[:, layer.cfg.n_experts:].max()) == 0.0


def test_forced_capacity_drops_entries(layer):
    r = tmoe.route(torch.from_numpy(layer.params["router"]),
                   port_moe(layer.cfg),
                   torch.from_numpy(layer.x.reshape(B * S, -1)),
                   layer.capacity)
    kept = int(r.keep.sum())
    if layer.capacity <= 2:
        assert kept < B * S * layer.cfg.top_k
    assert kept <= layer.cfg.n_phys * layer.capacity
    # the kept entries fill each expert's first slots, in token order
    for e in range(layer.cfg.n_phys):
        mine = r.se == e
        assert torch.equal(r.pos[mine], torch.arange(int(mine.sum())))
        assert bool((r.stok[mine][1:] > r.stok[mine][:-1]).all())


def test_output_and_aux_equal_the_reference(layer):
    jout, jaux = jmoe.moe_ffn(layer.params, layer.cfg,
                              jnp.asarray(layer.x), capacity=layer.capacity)
    out, aux = tmoe.moe_ffn(_tensors(layer.params), port_moe(layer.cfg),
                            torch.from_numpy(layer.x),
                            capacity=layer.capacity)
    assert out.dtype == torch.float32 and out.shape == layer.x.shape
    _close(out.numpy(), jout, TOL)
    _close(float(aux), float(jaux), TOL)


def test_gradients_equal_the_reference(layer):
    def jloss(p, x):
        out, aux = jmoe.moe_ffn(p, layer.cfg, x, capacity=layer.capacity)
        return jnp.sum(out * layer.cot) + aux

    jp, jx = jax.grad(jloss, argnums=(0, 1))(layer.params,
                                             jnp.asarray(layer.x))
    params = _tensors(layer.params, grad=True)
    x = torch.from_numpy(layer.x).requires_grad_()
    out, aux = tmoe.moe_ffn(params, port_moe(layer.cfg), x,
                            capacity=layer.capacity)
    ((out * torch.from_numpy(layer.cot)).sum() + aux).backward()
    _close(x.grad.numpy(), jx, GRAD_TOL)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(jax.tree.leaves(params))
    for path, want in flat:
        got = params
        for key in path:
            got = got[key.key]
        _close(got.grad.numpy(), want, GRAD_TOL)


def test_combine_is_one_segment_sum_call(layer, monkeypatch):
    calls = []
    real = tmoe.segment_sum

    def spy(msgs, seg, n, **kw):
        calls.append((tuple(msgs.shape), n))
        return real(msgs, seg, n, **kw)

    monkeypatch.setattr(tmoe, "segment_sum", spy)
    before = dict(tk4.LAUNCHES)
    tmoe.moe_ffn(_tensors(layer.params), port_moe(layer.cfg),
                 torch.from_numpy(layer.x), capacity=layer.capacity)
    d, k = layer.x.shape[-1], layer.cfg.top_k
    assert calls == [((B * S * k, d), B * S)]
    assert tk4.LAUNCHES == before  # the CPU runs the plain version


def test_moe_ffn_runs_no_host_sync(layer, monkeypatch):
    """Every op of routing, dispatch and combine leaves its output size
    to the host's shapes: none is in the auditor's ``SYNC_OPS`` (the
    aux loss's counts included).  The combine's segment sum is the K4
    wrapper's own concern; here it is a sync-free stand-in."""
    from repro_torch.analysis import walker

    def combine(msgs, seg, n, **kw):
        return msgs.new_zeros((n, msgs.shape[1])).index_add_(0, seg, msgs)

    monkeypatch.setattr(tmoe, "segment_sum", combine)
    with walker.OpRecorder() as rec:
        tmoe.moe_ffn(_tensors(layer.params), port_moe(layer.cfg),
                     torch.from_numpy(layer.x), capacity=layer.capacity)
    assert rec.record
    assert walker.sync_ops(rec.record) == []


def test_a2a_dispatch_takes_the_sort_based_path():
    jcfg = jlm.QWEN2_MOE_SMOKE
    params = _tensors(jax.tree.map(np.asarray, jmoe.moe_ffn_init(
        jax.random.key(5), jcfg.moe, jcfg.d_model)))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 5, jcfg.d_model)).astype(np.float32))
    cfg = port_moe(jcfg.moe)
    want = tmoe.moe_ffn(params, cfg, x)
    got = tmoe.moe_ffn(params, dataclasses.replace(cfg, dispatch="a2a"), x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ------------------------------------------------------------- the model


@dataclasses.dataclass
class ModelRun:
    jcfg: object
    params: dict           # the reference's tree (jax arrays)
    model: ttfm.TransformerLM
    tokens: np.ndarray


@pytest.fixture(scope="module", params=["qwen2-moe-smoke",
                                        "phi3.5-moe-smoke"])
def model_run(request) -> ModelRun:
    jcfg = CASES[request.param][0]
    params = jtfm.init_params(jax.random.key(0), jcfg)
    model = lm_params_from_numpy(port_cfg(jcfg),
                                 jax.tree.map(np.asarray, params), "cpu")
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab, (B, S)).astype(np.int32)
    return ModelRun(jcfg, params, model, tokens)


def test_forward_equals_the_reference(model_run):
    jl, jaux = jtfm.forward(model_run.jcfg, model_run.params,
                            jnp.asarray(model_run.tokens))
    with torch.no_grad():
        tl, taux = model_run.model(torch.from_numpy(model_run.tokens))
    _close(tl.numpy(), jl, TOL)
    _close(float(taux), float(jaux), TOL)


def test_prefill_and_decode_equal_the_reference(model_run):
    jcfg, max_len = model_run.jcfg, S + 3
    tok = jnp.asarray(model_run.tokens)
    jl, jc = jtfm.prefill(jcfg, model_run.params, tok, max_len)
    tl, tc = model_run.model.prefill(torch.from_numpy(model_run.tokens),
                                     max_len)
    _close(tl.numpy(), jl, TOL)
    for a, b in zip(tc, jc):
        _close(a.numpy(), b, TOL)
    # decode steps of batch 2: capacity 1, entries past an expert's
    # first dropped, as in the reference
    ids = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for i in range(2):
        jl, jc = jtfm.decode_step(jcfg, model_run.params, jc,
                                  jnp.asarray(ids), jnp.int32(S + i))
        tl, tc = model_run.model.decode_step(tc, torch.from_numpy(ids),
                                             S + i)
        _close(tl.numpy(), jl, TOL)
        ids = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)


def test_one_training_step_equals_the_reference(model_run):
    from repro.launch import steps as jsteps
    from repro.train import optimizer as jopt

    jcfg = model_run.jcfg
    ocfg = topt.OptConfig(kind="adamw", lr=1e-3, warmup=1, total_steps=4)
    jocfg = jopt.OptConfig(**dataclasses.asdict(ocfg))
    params = start = jtfm.init_params(jax.random.key(0), jcfg)
    model = lm_params_from_numpy(port_cfg(jcfg),
                                 jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    tok, lab = toks[:, :-1], toks[:, 1:]
    params, _, jm = jsteps.lm_train_step(jcfg, jocfg)(
        params, jopt.opt_init(jocfg, params), jnp.asarray(tok),
        jnp.asarray(lab))
    state = topt.opt_init(ocfg, dict(model.named_parameters()))
    state, tm = tsteps.lm_train_step(model.cfg, ocfg)(
        model, state, torch.from_numpy(tok), torch.from_numpy(lab))
    _close(float(tm["loss"]), float(jm["loss"]), TOL)
    _close(float(tm["grad_norm"]), float(jm["grad_norm"]), GRAD_TOL)
    # one AdamW step moves each weight by lr * g / (|g| + eps), about
    # lr * sign(g): the weights agree to 1e-6 wherever the gradient is
    # clear of 0 (|g| >= G_MIN), and within 2 lr where a gradient near 0
    # (Adam's eps is 1e-8) amplifies a float32 gap
    _, jg = jax.value_and_grad(lambda p: jtfm.loss_fn(
        jcfg, p, jnp.asarray(tok), jnp.asarray(lab)))(start)
    tree = jax.tree.map(np.asarray, params)
    grads = jax.tree.map(np.asarray, jg)
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        want, g = (_ref(t, name) for t in (tree, grads))
        gap = np.abs(got - want)
        assert gap.max() <= 2 * ocfg.lr, (name, gap.max())
        clear = np.abs(g) >= G_MIN
        assert (gap[clear] <= 1e-6).all(), (name, gap[clear].max())


def _ref(tree, name):
    parts = name.split(".")
    if parts[0] != "layers":
        return tree[parts[0]]
    leaf = tree["layers"]
    for key in parts[2:]:
        leaf = leaf[key]
    return leaf[int(parts[1])]


def test_converter_carries_every_moe_leaf(model_run):
    tree = jax.tree.map(np.asarray, model_run.params)
    moe = tree["layers"]["moe"]
    for i, lp in enumerate(model_run.model.layers):
        assert not hasattr(lp, "mlp")
        np.testing.assert_array_equal(lp.moe.router.detach().numpy(),
                                      moe["router"][i])
        for part in ("experts", "shared"):
            mods = getattr(lp.moe, part)
            assert (mods is None) == (part not in moe)
            for name, p in (mods or {}).items():
                np.testing.assert_array_equal(p.detach().numpy(),
                                              moe[part][name][i])
    want = sum(np.asarray(x).size for x in jax.tree.leaves(tree))
    assert sum(p.numel() for p in model_run.model.parameters()) == want
    bad = dict(tree, layers=dict(tree["layers"], moe=dict(
        moe, router=moe["router"][:, :, :-1])))
    with pytest.raises(ValueError, match="layers.moe.router"):
        lm_params_from_numpy(port_cfg(model_run.jcfg), bad, "cpu")


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b"])
def test_moe_configs_equal_the_reference(arch):
    from repro.configs.registry import arch_module as j_arch_module

    for which in ("CONFIG", "SMOKE"):
        got = getattr(arch_module(arch), which)
        want = getattr(j_arch_module(arch), which)
        assert got == port_cfg(want)
        d = want.d_model
        assert got.moe.n_phys == want.moe.n_phys
        assert got.moe.param_count(d) == want.moe.param_count(d)
        assert got.moe.active_param_count(d) == \
            want.moe.active_param_count(d)


def test_init_params_draws_the_moe_leaves_seeded():
    cfg = tlm.QWEN2_MOE_SMOKE
    a = ttfm.init_params(cfg, seed=0, device="cpu")
    b = ttfm.init_params(cfg, seed=0, device="cpu")
    c = ttfm.init_params(cfg, seed=1, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    w = sa["layers.0.moe.experts.w_gate"]
    # every expert slot drawn, each its own draw, at dense_init's scale
    assert all(float(w[e].std()) > 0 for e in range(w.shape[0]))
    assert not torch.equal(w[0], w[1])
    assert not torch.equal(w, sc["layers.0.moe.experts.w_gate"])
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    assert abs(float(w.std()) - (2 / (d + f)) ** 0.5) < 0.1 * (
        2 / (d + f)) ** 0.5
    assert float(sa["layers.0.ln_mlp"].abs().max()) == 0.0
    assert a.init_seconds > 0


def test_init_params_do_not_depend_on_the_thread_count(monkeypatch):
    from repro_torch.models import layers as tlayers

    cfg = tlm.QWEN2_MOE_SMOKE
    states = []
    for cpus in (1, 3, 8):
        monkeypatch.setattr(tlayers.os, "cpu_count", lambda c=cpus: c)
        states.append(ttfm.init_params(cfg, seed=0, device="cpu").state_dict())
    for other in states[1:]:
        assert other.keys() == states[0].keys()
        for k in states[0]:
            assert torch.equal(other[k], states[0][k]), k
