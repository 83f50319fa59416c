"""The port's examples (``examples/torch/*.py``) run on the CPU at their
smallest sizes, each held against the reference's example
(``examples/*.py``) or the oracle:

* ``quickstart.py`` prints the reference quickstart's lines, number for
  number (the backend's name aside: ``torch`` for ``jnp``), and its
  counts equal networkx's and ``tests/oracle.py``'s;
* ``distributed_tc.py`` at RMAT scale 8 over ``LocalShards(8)``: the
  triangles equal the wedge baseline's, the oracle's and the reference
  engine's, the hedge plan equals the reference's ``plan_hedge_rounds``,
  the modelled bytes the reference's ``comm_model``, and the measured
  wire bytes the tally and the model;
* ``gnn_cora.py``: the triangle features equal the reference example's
  ``triangle_features`` on the same graph (the levels and the per-vertex
  credit bit for bit, the credit's log1p to an ulp), and GAT's loss
  falls;
* ``train_lm.py``: a run stopped and restarted from its checkpoint ends
  with the weights and losses of an uninterrupted run, bit for bit; and
  on the reference's weights and the same numpy batches, its losses
  step for step equal the reference example's loop's.
"""
from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import TCOptions as JOptions
from repro.api import TriangleEngine as JEngine
from repro.configs import data as jdata
from repro.configs import registry as jreg
from repro.core import comm_model as jcm
from repro.core.parallel_tc import plan_hedge_rounds as j_plan_hedge_rounds
from repro.graph import generators as jgen
from repro.graph.csr import from_edges as j_from_edges
from tests import oracle

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name: str):
    return _load(ROOT / "examples" / "torch" / f"{name}.py",
                 f"torch_example_{name}")


def _reference(name: str):
    return _load(ROOT / "examples" / f"{name}.py", f"reference_{name}")


# ------------------------------------------------------------ quickstart

def test_quickstart_prints_the_reference_examples_numbers(capsys):
    _reference("quickstart").main()
    want = capsys.readouterr().out
    got = _port("quickstart").main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert printed == want.replace("jnp", "torch")
    for name, row in got["counts"].items():
        assert row["triangles"] == row["oracle"], name
    assert got["oracle"] == "networkx"
    for row in got["counts"].values():
        assert f"triangles = {row['triangles']} (networkx:" in want


def test_quickstart_counts_equal_the_oracle(monkeypatch, capsys):
    """Without networkx (as on a host with no networkx) the example
    falls back to the set intersection and says so."""
    qs = _port("quickstart")
    for name, make in qs.GRAPHS.items():
        edges, n = make()
        want = oracle.total_triangles(edges, n)
        assert qs.set_triangles(edges, n) == want, name
        assert qs.networkx_triangles(edges, n) == want, name
    assert qs.pick_oracle()[0] == "networkx"
    monkeypatch.setitem(sys.modules, "networkx", None)   # import fails
    assert qs.pick_oracle() == ("sets", qs.set_triangles)
    out = qs.main(["--device", "cpu"])
    assert out["oracle"] == "sets"
    assert "triangles = 45 (sets: 45)" in capsys.readouterr().out
    assert [r["triangles"] for r in out["counts"].values()] == [
        45, 74, 75682]
    assert out["batch"] == [45, 84, 24]
    found = out["found"]
    assert found.shape == (45, 3)
    assert len({tuple(sorted(t)) for t in found.tolist()}) == 45


# -------------------------------------------------------- distributed_tc

def test_distributed_tc_matches_the_reference_and_the_oracle(capsys):
    got = _port("distributed_tc").main(["--device", "cpu", "--scale", "8"])
    out = capsys.readouterr().out
    edges, n = jgen.rmat(8, 16, seed=0)
    want = oracle.total_triangles(edges, n)
    assert got["triangles"] == got["wedge_triangles"] == want
    assert JEngine().count((edges, n)).triangles == want
    assert sum(got["per_device"]) == want and len(got["per_device"]) == 8
    assert got["plan_id"] == "hedge/ring/p8"
    jplan = j_plan_hedge_rounds(j_from_edges(edges, n), 8, mode="ring",
                                hedge_chunk=512)
    assert got["buckets"] == [(b.rows, b.d_cand, b.d_targ)
                              for b in jplan.buckets]
    assert got["modelled_bytes"]["cover_edge"] == jcm.cover_edge_comm(
        n, got["m"], got["k"], 8).total_bytes
    for ph, row in got["wire_bytes"].items():
        assert row["measured"] == row["tally"] == row["modeled"], ph
        assert f"{ph:>9}: measured={row['measured']:>10} ==" in out
    assert f"cover-edge (ring): T={want}" in out


# -------------------------------------------------------------- gnn_cora

def test_gnn_cora_features_equal_the_reference_examples(capsys):
    ref = _reference("gnn_cora")
    cfg = jreg.arch_module("gat-cora").SMOKE
    batch = jdata.gnn_batch("gat-cora", cfg, n_nodes=300, n_edges_und=1200,
                            d_feat=8, seed=1)
    edges = np.stack([np.asarray(batch.src), np.asarray(batch.dst)], 1)
    want = np.asarray(ref.triangle_features(edges, 300))
    ref_line = capsys.readouterr().out.splitlines()[0]
    got = _port("gnn_cora").main(["--device", "cpu", "--steps", "40"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ref_line
    feats = got["features"].numpy()
    # the levels bit for bit; log1p of the credit to an ulp (XLA's log1p
    # and torch's round apart in 11 of 300 rows)
    np.testing.assert_array_equal(feats[:, 0], want[:, 0])
    np.testing.assert_allclose(feats[:, 1], want[:, 1], rtol=2.4e-7,
                               atol=0)
    jrep = JEngine().count(j_from_edges(edges, 300),
                           options=JOptions(per_vertex=True))
    np.testing.assert_array_equal(got["per_vertex"],
                                  np.asarray(jrep.per_vertex))
    np.testing.assert_array_equal(got["levels"], np.asarray(jrep.levels))
    assert got["triangles"] == jrep.triangles
    assert int(got["per_vertex"].sum()) == 3 * got["triangles"]
    losses = got["losses"]
    assert len(losses) == 40 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert "step 40: loss" in lines[-1]


# -------------------------------------------------------------- train_lm

def test_train_lm_restart_equals_an_uninterrupted_run(tmp_path):
    lm = _port("train_lm")
    argv = ["--device", "cpu", "--steps", "6", "--batch", "2", "--seq", "8"]
    clean = lm.main(argv + ["--restart-at", "0"])
    again = lm.main(argv + ["--restart-at", "3", "--ckpt-dir",
                            str(tmp_path)])
    assert clean["resumed_from"] is None and again["resumed_from"] == 3
    assert again["steps"] == clean["steps"] == 6
    assert again["history"] == clean["history"]
    assert np.isfinite(clean["history"]).all()
    assert clean["state"].keys() == again["state"].keys()
    for k, v in clean["state"].items():
        assert torch.equal(v, again["state"][k]), k
    assert list(tmp_path.iterdir())              # the checkpoints it kept
    # a relaunch over a finished run's checkpoint resumes at its end
    done = lm.main(argv + ["--ckpt-dir", str(tmp_path)])
    assert done["steps"] == 6 and done["history"] == []


class _NumpyTokens:
    """Next-token batches of a numpy generator seeded by the cursor, as
    ``wrap`` arrays: the same batches for both packages' trainers (each
    package's own ``LMStream`` draws its own tokens)."""

    def __init__(self, cfg, batch, seq, *, wrap, **_):
        self.cfg, self.batch, self.seq, self.wrap = cfg, batch, seq, wrap
        self.cursor = 0

    def __iter__(self):
        return self

    def __next__(self):
        rng = np.random.default_rng(100 + self.cursor)
        self.cursor += 1
        toks = rng.integers(0, self.cfg.vocab, (self.batch, self.seq + 1))
        return self.wrap(toks[:, :-1]), self.wrap(toks[:, 1:])


def test_train_lm_losses_equal_the_reference_examples(tmp_path,
                                                      monkeypatch):
    """The reference example's loop (its weights, its trainer) and the
    port's, restarted halfway from its checkpoint, on the same numpy
    batches: every step's loss within LOSS_TOL * (1 + |ref|), the
    tolerance of ``tests/test_torch_lm_train.py``'s AdamW steps."""
    import jax
    import jax.numpy as jnp

    from repro.launch import steps as jsteps
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.convert import lm_params_from_numpy

    loss_tol = 2e-5
    steps, argv = 6, ["--steps", "6", "--batch", "2", "--seq", "8"]
    ref = _reference("train_lm")
    reports = []

    class RecordingTrainer(ref.Trainer):
        def fit(self, *a, **kw):
            reports.append(super().fit(*a, **kw))
            return reports[-1]

    monkeypatch.setattr(ref, "Trainer", RecordingTrainer)
    monkeypatch.setattr(ref, "LMStream", lambda *a, **kw: _NumpyTokens(
        *a, wrap=lambda x: jnp.asarray(x, jnp.int32), **kw))
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *argv, "--ckpt-dir",
                                      str(tmp_path / "ref")])
    ref.main()
    want = reports[0]["history"]
    assert len(want) == steps

    jcfg = jreg.arch_module("smollm-135m").SMOKE
    tree = jax.tree.map(np.asarray, jsteps.init_for("smollm-135m", jcfg,
                                                    jax.random.key(0)))
    monkeypatch.setattr(tsteps, "init_for", lambda arch, cfg, seed, device:
                        lm_params_from_numpy(cfg, tree, device))
    lm = _port("train_lm")
    monkeypatch.setattr(lm, "LMStream", lambda *a, **kw: _NumpyTokens(
        *a, wrap=torch.from_numpy, **kw))
    got = lm.main(["--device", "cpu", *argv, "--restart-at", "3",
                   "--ckpt-dir", str(tmp_path / "port")])
    assert got["resumed_from"] == 3 and len(got["history"]) == steps
    for i, (g, w) in enumerate(zip(got["history"], want)):
        assert abs(g - w) <= loss_tol * (1 + abs(w)), (i, g, w)


@pytest.mark.parametrize("name", ["quickstart", "distributed_tc",
                                  "gnn_cora", "train_lm"])
def test_examples_run_on_the_card_by_default(name, monkeypatch):
    """Each example's ``--device`` defaults to ``cuda``: without a card
    it raises, naming the CPU path, rather than running there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = _port(name)
    src = (ROOT / "examples" / "torch" / f"{name}.py").read_text()
    assert re.search(r'"--device", default="cuda"', src)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])
