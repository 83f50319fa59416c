"""The port's LM serving path held against ``repro.models.transformer``:
the layers, ``prefill`` and ``decode_step`` logits and caches, ``forward``
and greedy ids, on the smollm-135m and gemma3-1b smoke configs (the
latter covers the sliding window, qk-norm and gelu) and on a 2-layer
smollm-135m at full width (d_model 576, vocab 49,152), with the
reference's weights carried across by ``lm_params_from_numpy``.  Also the
server on the CPU, its refusal to fall back from the card, the configs
and the architectures the port does not run yet.  Inputs are numpy
arrays made from a seed."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm as jlm
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch.configs import lm as tlm
from repro_torch.configs.registry import ARCH_MODULES, arch_module
from repro_torch.kernels.flash_attention import flash_attention as tkern
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.models.convert import cache_from_numpy, lm_params_from_numpy

torch.set_num_threads(1)

# float32 end to end: the reference's own kernel tolerance.  The port and
# the reference sum in other orders (matmuls, softmax); the largest
# difference seen on these configs is 4e-6 (logits up to 5 in magnitude).
TOL = 2e-5
# act_dtype bfloat16: the reference rounds the attention probabilities to
# bf16 before the PV product and the port keeps them float32 (K5 and its
# plain version accumulate in float32); 1e-2 seen on logits below 0.7.
BF16_TOL = 3e-2


def _port_cfg(jcfg) -> ttfm.LMConfig:
    names = {f.name for f in dataclasses.fields(ttfm.LMConfig)}
    kw = {n: getattr(jcfg, n) for n in names}
    if jcfg.moe is not None:
        kw["moe"] = tmoe.MoEConfig(**dataclasses.asdict(jcfg.moe))
    return ttfm.LMConfig(**kw)


# (config, batch, prompt length, generated tokens)
CONFIGS = {
    "smollm-135m-smoke": (jlm.SMOLLM_135M_SMOKE, 2, 12, 5),
    "gemma3-1b-smoke": (jlm.GEMMA3_1B_SMOKE, 2, 20, 5),
    "smollm-135m-2layer-full-width": (
        dataclasses.replace(jlm.SMOLLM_135M, n_layers=2), 2, 12, 4),
}


@dataclasses.dataclass
class Run:
    """One config through both packages: the reference's results and the
    port's, on the same weights and prompt."""
    jcfg: object
    model: ttfm.TransformerLM
    tokens: np.ndarray
    jax_prefill: tuple       # (logits, cache) as numpy
    port_prefill: tuple      # (logits, cache) as numpy, copied
    jax_steps: list          # per decode step: (logits, ids fed)
    port_steps: list
    jax_cache: tuple         # after the last decode step
    port_cache: tuple
    jax_forward: np.ndarray
    port_forward: np.ndarray


def _np_cache(cache):
    return tuple(np.array(c) for c in cache)


@pytest.fixture(scope="module", params=list(CONFIGS))
def run(request) -> Run:
    jcfg, b, s, gen = CONFIGS[request.param]
    params = jtfm.init_params(jax.random.key(0), jcfg)
    model = lm_params_from_numpy(_port_cfg(jcfg),
                                 jax.tree.map(np.asarray, params), "cpu")
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab, (b, s)).astype(np.int32)
    max_len = s + gen
    jl, jc = jax.jit(lambda p, t: jtfm.prefill(jcfg, p, t, max_len))(
        params, jnp.asarray(tokens))
    tl, tc = model.prefill(torch.from_numpy(tokens), max_len)
    jax_prefill = (np.asarray(jl), _np_cache(jc))
    port_prefill = (tl.numpy().copy(), _np_cache(tc))
    # each package decodes its own greedy ids, free running
    dec = jax.jit(lambda p, c, t, i: jtfm.decode_step(jcfg, p, c, t, i))
    jid, tid = jnp.argmax(jl, -1)[:, None], tl.argmax(-1)[:, None]
    jax_steps, port_steps = [], []
    for i in range(gen - 1):
        jl, jc = dec(params, jc, jid, jnp.int32(s + i))
        tl, tc = model.decode_step(tc, tid, s + i)
        jax_steps.append((np.asarray(jl), np.asarray(jid)))
        port_steps.append((tl.numpy().copy(), tid.numpy().copy()))
        jid, tid = jnp.argmax(jl, -1)[:, None], tl.argmax(-1)[:, None]
    jf, _ = jax.jit(lambda p, t: jtfm.forward(jcfg, p, t))(
        params, jnp.asarray(tokens))
    with torch.no_grad():
        tf, aux = model(torch.from_numpy(tokens))
    assert aux == 0.0
    return Run(jcfg, model, tokens, jax_prefill, port_prefill, jax_steps,
               port_steps, _np_cache(jc), _np_cache(tc), np.asarray(jf),
               tf.numpy())


# ------------------------------------------------------------------ layers


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def test_rmsnorm(rng):
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32) * 0.1
    got = tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), eps=1e-6)
    want = jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w), eps=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(rng, theta):
    x = rng.standard_normal((2, 7, 3, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, 107)[None], (2, 7)).astype(np.int32)
    tc, ts = tlayers.rope_freqs(64, theta, torch.from_numpy(pos.copy()))
    jc, js = jlayers.rope_freqs(64, theta, jnp.asarray(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=TOL, atol=TOL)
    got = tlayers.apply_rope(torch.from_numpy(x), tc[:, :, None], ts[:, :, None])
    want = jlayers.apply_rope(jnp.asarray(x), jc[:, :, None], js[:, :, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_glu_mlp(rng, act):
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    ws = {n: rng.standard_normal(s).astype(np.float32) * 0.2 for n, s in
          (("w_gate", (32, 64)), ("w_up", (32, 64)), ("w_down", (64, 32)))}
    got = tlayers.glu_mlp({n: torch.from_numpy(w) for n, w in ws.items()},
                          torch.from_numpy(x), act=act)
    want = jlayers.glu_mlp({n: jnp.asarray(w) for n, w in ws.items()},
                           jnp.asarray(x), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_initialisers_shapes_and_scales():
    gen = torch.Generator().manual_seed(0)
    w = tlayers.dense_init(gen, 576, 1536)
    e = tlayers.embed_init(gen, 4096, 64)
    assert w.shape == (576, 1536) and e.shape == (4096, 64)
    assert abs(w.std().item() - (2.0 / (576 + 1536)) ** 0.5) < 1e-3
    assert abs(e.std().item() - 0.02) < 1e-3


# ------------------------------------------------------------ the model


def test_prefill_logits(run):
    np.testing.assert_allclose(run.port_prefill[0], run.jax_prefill[0],
                               rtol=TOL, atol=TOL)


def test_prefill_cache(run):
    for got, want in zip(run.port_prefill[1], run.jax_prefill[1]):
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_decode_logits(run):
    for (got, _), (want, _) in zip(run.port_steps, run.jax_steps):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_decode_cache(run):
    for got, want in zip(run.port_cache, run.jax_cache):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_greedy_ids(run):
    got = [ids for _, ids in run.port_steps]
    want = [ids for _, ids in run.jax_steps]
    assert [g.ravel().tolist() for g in got] == [
        w.ravel().tolist() for w in want]


def test_forward_logits(run):
    assert run.port_forward.shape == (*run.tokens.shape, run.jcfg.vocab)
    np.testing.assert_allclose(run.port_forward, run.jax_forward, rtol=TOL,
                               atol=TOL)


def test_decode_from_reference_cache(run):
    """The reference's prefill cache, carried across, decodes to the
    reference's first step."""
    cache = cache_from_numpy(run.jax_prefill[1], "cpu")
    s = run.tokens.shape[1]
    logits, _ = run.model.decode_step(
        cache, torch.tensor(run.jax_steps[0][1]), s)
    np.testing.assert_allclose(logits.numpy(), run.jax_steps[0][0],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["smollm-135m-smoke", "gemma3-1b-smoke"])
def test_act_dtype_bfloat16(name):
    jcfg = dataclasses.replace(CONFIGS[name][0], act_dtype="bfloat16")
    params = jtfm.init_params(jax.random.key(0), jcfg)
    model = lm_params_from_numpy(_port_cfg(jcfg),
                                 jax.tree.map(np.asarray, params), "cpu")
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab, (2, 12)).astype(np.int32)
    jl, jc = jtfm.prefill(jcfg, params, jnp.asarray(tokens), 16)
    tl, tc = model.prefill(torch.from_numpy(tokens), 16)
    assert tl.dtype == torch.float32 and tc[0].dtype == torch.bfloat16
    assert jc[0].dtype == jnp.bfloat16
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=BF16_TOL)


def test_decode_position_outside_cache_raises(run):
    cache = cache_from_numpy(run.jax_prefill[1], "cpu")
    t = cache[0].shape[2]
    token = torch.zeros((run.tokens.shape[0], 1), dtype=torch.long)
    with pytest.raises(ValueError):
        run.model.decode_step(cache, token, t)


def test_convert_rejects_a_wrong_shape():
    jcfg = jlm.SMOLLM_135M_SMOKE
    tree = jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(0), jcfg))
    tree["embed"] = tree["embed"][:, :-1]
    with pytest.raises(ValueError, match="embed"):
        lm_params_from_numpy(_port_cfg(jcfg), tree, "cpu")


# ----------------------------------------------------------- the server


def test_serve_cpu(capsys):
    res = tserve.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8", "--gen", "5"])
    out = capsys.readouterr().out
    assert "smollm-135m-smoke: prefill 2x8 in" in out
    assert "4 decode steps in" in out and "generated ids[0]:" in out
    assert res.ids.shape == (2, 5) and res.logits.shape == (5, 2, 512)
    assert torch.equal(res.ids, res.logits.argmax(-1).T)
    assert torch.isfinite(res.logits).all()
    assert res.prefill_s > 0 and res.decode_s > 0


def test_serve_teacher_forced_with_its_own_ids_repeats_itself():
    cfg = tlm.SMOLLM_135M_SMOKE
    model = ttfm.init_params(cfg, seed=3, device="cpu")
    tokens = tserve.prompt_tokens(cfg, 2, 8, "cpu")
    free = tserve.serve(model, tokens, 6)
    forced = tserve.serve(model, tokens, 6, forced=free.ids)
    assert torch.equal(free.ids, forced.ids)
    assert torch.equal(free.logits, forced.logits)


def test_serve_matches_reference_greedy_loop():
    """The server's loop against the reference's (``repro.launch.serve``'s
    prefill and decode loop) on the same weights and prompt."""
    jcfg = jlm.GEMMA3_1B_SMOKE
    params = jtfm.init_params(jax.random.key(1), jcfg)
    model = lm_params_from_numpy(_port_cfg(jcfg),
                                 jax.tree.map(np.asarray, params), "cpu")
    tokens = tserve.prompt_tokens(_port_cfg(jcfg), 2, 10, "cpu")
    res = tserve.serve(model, tokens, 4)
    jl, cache = jtfm.prefill(jcfg, params, jnp.asarray(tokens.numpy()), 14)
    ids = [jnp.argmax(jl, -1)]
    for i in range(3):
        jl, cache = jtfm.decode_step(jcfg, params, cache, ids[-1][:, None],
                                     jnp.int32(10 + i))
        ids.append(jnp.argmax(jl, -1))
    assert res.ids.tolist() == np.stack(ids, 1).tolist()
    np.testing.assert_allclose(res.logits[-1].numpy(), np.asarray(jl),
                               rtol=TOL, atol=TOL)


def test_steps_are_the_models_entry_points():
    cfg = tlm.SMOLLM_135M_SMOKE
    model = tsteps.init_for("smollm-135m", cfg, seed=2, device="cpu")
    tokens = tserve.prompt_tokens(cfg, 2, 6, "cpu")
    logits, cache = tsteps.lm_prefill_step(cfg, 9)(model, tokens)
    want, want_cache = model.prefill(tokens, 9)
    assert torch.equal(logits, want)
    step = tsteps.lm_decode_step(cfg)
    got, _ = step(model, cache, logits.argmax(-1)[:, None], 6)
    want, _ = model.decode_step(want_cache, want.argmax(-1)[:, None], 6)
    assert torch.equal(got, want)


def test_serve_cpu_launches_no_kernel():
    before = dict(tkern.LAUNCHES)
    tserve.main(["--smoke", "--device", "cpu", "--batch", "1",
                 "--prompt-len", "4", "--gen", "2"])
    assert tkern.LAUNCHES == before


def test_serve_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--smoke", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttfm.init_params(tlm.SMOLLM_135M_SMOKE)


def test_init_cache_is_on_the_card_unless_asked(monkeypatch):
    cfg = tlm.SMOLLM_135M_SMOKE
    k, v = ttfm.init_cache(cfg, 1, 8, device="cpu")
    want = (cfg.n_layers, 1, 8, cfg.n_kv_heads, cfg.d_head)
    assert k.shape == v.shape == want and k.device.type == "cpu"
    assert not k.any() and not v.any()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttfm.init_cache(cfg, 1, 8)


# ------------------------------------------------------------ configs


@pytest.mark.parametrize("name,which", [
    (a, w) for a in ("smollm-135m", "gemma3-1b", "gemma3-4b",
                     "qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b")
    for w in ("CONFIG", "SMOKE")])
def test_configs_equal_the_reference(name, which):
    from repro.configs.registry import arch_module as j_arch_module

    got = getattr(arch_module(name), which)
    want = getattr(j_arch_module(name), which)
    assert got == _port_cfg(want)
    assert got.layer_windows == want.layer_windows
    assert arch_module(name).FAMILY == "lm"


def test_registry_lists_the_dense_lms():
    """The dense LMs, and since LM training and MoE are ported the two
    MoE LMs beside them."""
    lms = {a for a in ARCH_MODULES if arch_module(a).FAMILY == "lm"}
    dense = {a for a in lms if arch_module(a).CONFIG.moe is None}
    assert dense == {"smollm-135m", "gemma3-1b", "gemma3-4b"}
    assert lms - dense == {"qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b"}
    assert set(ARCH_MODULES) == lms | {"gatedgcn", "gat-cora", "schnet",
                                       "dimenet", "bst", "cover-edge-tc"}


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b",
                                  "cover-edge-tc", "bst"])
def test_unported_archs_raise_naming_the_queue(arch):
    """Every architecture of the reference is ported: the MoE LMs' and
    BST's config modules resolve and their smoke models build;
    ``cover-edge-tc`` resolves to the triangle count's config, which has
    no weights, so ``init_for`` raises for it alone."""
    mod = arch_module(arch)
    if arch.startswith(("qwen2", "phi3.5")):
        assert mod.FAMILY == "lm" and mod.SMOKE.moe is not None
        model = tsteps.init_for(arch, mod.SMOKE, device="cpu")
        assert all(hasattr(lp, "moe") for lp in model.layers)
        return
    if arch == "bst":
        assert mod.FAMILY == "recsys"
        model = tsteps.init_for(arch, mod.SMOKE, device="cpu")
        assert model.item_embed.shape == (mod.SMOKE.item_vocab,
                                          mod.SMOKE.embed_dim)
        return
    assert mod.FAMILY == "tc" and mod.SHAPES["rmat_smoke"]["scale"] == 10
    with pytest.raises(ValueError, match="no weights"):
        tsteps.init_for(arch, mod.SMOKE, device="cpu")


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        arch_module("no-such-arch")


@pytest.mark.parametrize("jcfg", [jlm.QWEN2_MOE_SMOKE, jlm.PHI35_MOE_SMOKE],
                         ids=lambda c: c.name)
def test_moe_config_raises(jcfg):
    """MoE configs build now (ported with LM training): both smoke
    models, with the reference's parameter count."""
    cfg = _port_cfg(jcfg)
    built = ttfm.TransformerLM(cfg)
    drawn = ttfm.init_params(cfg, device="cpu")
    for model in (built, drawn):
        assert sum(p.numel() for p in model.parameters()) == \
            jcfg.param_count()
    logits, aux = drawn(torch.zeros((1, 4), dtype=torch.long))
    assert logits.shape == (1, 4, jcfg.vocab) and torch.isfinite(aux)
