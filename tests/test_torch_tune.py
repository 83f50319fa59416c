"""The port's autotuner (``repro_torch.tune``) held against the reference's
(``repro.tune``) on the CPU: traces equal line for line and readable
across packages, ``record_serve_trace`` with the heavy tier, profiles
round-tripping into the reference's ``load_profile`` and carried across
from it (``profile_from_reference`` on ``results/tuned/serve_mix.json``,
read only), the corrupt-file degradation, the option resolution order,
the sweep space, ``_check_identical``, a two-config successive halving,
a shedding config refused, ``build_profile``, the prewarm contract with
its plan-cache keys equal to a reference prewarm's, a cold server's
plan misses, and a failing recorder that never raises from ``submit``."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.tune as jtune
from repro.graph import csr as jcsr
from repro.tune import sweep as jsweep
from repro_torch import api as tapi
from repro_torch import tune as ttune
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as gen
from repro_torch.tune import profile as tprofile
from repro_torch.tune import sweep as tsweep

CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]
#: the reference's tuned profile (read only: nothing here writes there)
SERVE_MIX_PROFILE = REPO / "results" / "tuned" / "serve_mix.json"
#: the reference's backend names -> the port's
BACKEND = {"auto": "auto", "jnp": "torch", "pallas": "cuda"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mini_requests(n=10, seed=7):
    """``tests/test_tune.py``'s small mix: ER graphs and cliques."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        if i % 3 == 2:
            reqs.append(gen.complete(5 + (i % 4)))
        else:
            reqs.append(gen.erdos_renyi(
                20 + 4 * i, 0.15, seed=int(rng.integers(1 << 30))))
    return reqs


def _record(engine, recorder_cls, reqs, path=None, batch_size=8):
    with recorder_cls(path) as rec:
        server = engine.serve(batch_size=batch_size, recorder=rec)
        for edges, n in reqs:
            server.submit(edges, n, deadline_s=1e9)
        server.drain()
        return list(rec.records), server


@pytest.fixture(scope="module")
def mini():
    """A small trace, recorded once by each package."""
    reqs = _mini_requests(8)
    t, _ = _record(tapi.TriangleEngine(device=CPU), ttune.TraceRecorder, reqs)
    j, _ = _record(japi.TriangleEngine(), jtune.TraceRecorder, reqs)
    return reqs, t, j


def _lines(records):
    return [json.dumps(r.to_json()) for r in records]


def _opts(o, *, reference: bool) -> dict:
    """An option set as a dict in the port's terms."""
    d = dataclasses.asdict(o)
    if reference:
        d.pop("interpret")
        d["backend"] = BACKEND[d["backend"]]
    return d


def _meta(m):
    return None if m is None else (m.d_pad, m.h_rows, tuple(m.exceed))


def _budget(b):
    return (b.n_budget, b.slot_budget)


# ------------------------------------------------------------- traces
def test_recorders_agree_line_for_line_and_read_each_other(mini, tmp_path):
    reqs, t, j = mini
    assert len(t) == len(j) == len(reqs)
    assert _lines(t) == _lines(j)
    assert ttune.trace_signature(t) == jtune.trace_signature(j)
    assert all(r.route == "batch" and r.budget is not None for r in t)
    tp = ttune.write_trace(t, str(tmp_path / "port.jsonl"))
    jp = jtune.write_trace(j, str(tmp_path / "ref.jsonl"))
    assert Path(tp).read_text() == Path(jp).read_text()
    assert _lines(jtune.read_trace(tp)) == _lines(ttune.read_trace(jp))
    for a, b in zip(ttune.read_trace(jp), j):
        np.testing.assert_array_equal(a.edges, b.edges)
        assert a.request() == (a.edges, b.n_nodes)


def test_recorder_file_is_written_as_requests_arrive(tmp_path):
    path = tmp_path / "sub" / "live.jsonl"
    reqs = _mini_requests(4)
    got, _ = _record(tapi.TriangleEngine(device=CPU), ttune.TraceRecorder,
                     reqs, path=str(path))
    back = ttune.read_trace(str(path))
    assert _lines(back) == _lines(got) and len(back) == 4
    assert [r.request_id for r in back] == [0, 1, 2, 3]


def test_distributed_route_records_no_budget():
    """Past a capped grid's top cell both servers record the request as
    ``"distributed"`` with no budget; the signature's ``dist`` cell."""
    grid_t = tcsr.BudgetGrid(max_nodes=256, max_slots=2048)
    grid_j = jcsr.BudgetGrid(max_nodes=256, max_slots=2048)
    reqs = [gen.karate(), gen.rmat(9, 8, seed=0)]
    t, srv = _record(tapi.TriangleEngine(budgets=grid_t, device=CPU),
                     ttune.TraceRecorder, reqs)
    j, _ = _record(japi.TriangleEngine(budgets=grid_j), jtune.TraceRecorder,
                   reqs)
    assert [r.route for r in t] == ["batch", "distributed"]
    assert t[1].budget is None and t[1].meta is not None
    assert _lines(t) == _lines(j)
    assert ttune.trace_signature(t) == jtune.trace_signature(j) == \
        "v1|64x256:0.5|dist:0.5"
    assert srv.summary()["distributed_requests"] == 1


def test_trace_records_refuse_what_they_cannot_replay():
    with pytest.raises(ValueError, match="version"):
        ttune.TraceRecord.from_json({"v": 99, "id": 0, "n_nodes": 1,
                                     "n_edges": 0, "route": "batch"})
    rec = ttune.TraceRecord(request_id=0, n_nodes=4, n_edges=0,
                            route="batch", budget=None, meta=None,
                            deadline_s=None, edges=None)
    with pytest.raises(ValueError, match="signature-only"):
        rec.request()
    assert ttune.trace_signature([]) == jtune.trace_signature([]) \
        == "v1|empty"


def test_record_serve_trace_with_heavy_tier_matches_reference():
    t = ttune.record_serve_trace(24, smoke=True, heavy_every=4, device=CPU)
    j = jtune.record_serve_trace(24, smoke=True, heavy_every=4)
    assert len(t) == 24 and _lines(t) == _lines(j)
    # every 4th request is the heavy tier's rmat(8 or 9, 8)
    assert all(t[i].n_nodes in (256, 512) for i in range(3, 24, 4))


# ----------------------------------------------------------- profiles
def _tiny_profile(records, ns):
    """``tests/test_tune.py``'s profile, built by the package ``ns``."""
    cfg = ns["SweepConfig"](
        "t", ns["TCOptions"](bucket_widths=(8, 64), row_mult=16),
        ns["BudgetGrid"](min_nodes=128, min_slots=1024, factor=4.0),
    )
    return ns["build_profile"](cfg, records,
                               objective={"graphs_per_s": 1.0})


_PORT = dict(SweepConfig=ttune.SweepConfig, TCOptions=tapi.TCOptions,
             BudgetGrid=tcsr.BudgetGrid, build_profile=ttune.build_profile)
_REF = dict(SweepConfig=jtune.SweepConfig, TCOptions=japi.TCOptions,
            BudgetGrid=jcsr.BudgetGrid, build_profile=jtune.build_profile)


def test_port_profile_roundtrips_and_loads_in_the_reference(mini, tmp_path):
    _, t, _ = mini
    profile = _tiny_profile(t, _PORT)
    path = profile.save(str(tmp_path / "p.json"))
    loaded = ttune.load_profile(path)
    assert loaded.signature == profile.signature
    assert loaded.options == profile.options and loaded.grid == profile.grid
    assert loaded.cells == profile.cells
    for cell in profile.cells:
        assert loaded.options_for(cell.budget) == profile.options
        assert loaded.meta_for(cell.budget) == cell.meta
    assert loaded.options_for(tcsr.ShapeBudget(1 << 20, 1 << 22)) == \
        profile.options
    # the port's JSON has no field the reference's TCOptions lacks
    ref = jtune.load_profile(path)
    assert ref is not None and ref.signature == profile.signature
    assert _opts(ref.options, reference=True) == _opts(profile.options,
                                                       reference=False)
    assert [(_budget(c.budget), _meta(c.meta)) for c in ref.cells] == [
        (_budget(c.budget), _meta(c.meta)) for c in profile.cells]
    assert dataclasses.asdict(ref.grid) == dataclasses.asdict(profile.grid)
    assert tprofile.PROFILE_DIR == str(Path("results") / "tuned_torch")
    assert tprofile.profile_path("v1|64x256:0.9") == str(
        Path("results") / "tuned_torch" / "v1_64x256_0.9.json")


def test_profile_from_reference_serve_mix():
    before = SERVE_MIX_PROFILE.read_bytes()
    ref = jtune.load_profile(str(SERVE_MIX_PROFILE))
    got = ttune.profile_from_reference(str(SERVE_MIX_PROFILE))
    assert got.signature == ref.signature
    assert got.objective == ref.objective
    assert dataclasses.asdict(got.grid) == dataclasses.asdict(ref.grid)
    assert [(_budget(c.budget), _meta(c.meta)) for c in got.cells] == [
        (_budget(c.budget), _meta(c.meta)) for c in ref.cells]
    assert len(got.cells) >= 2
    assert _opts(got.options, reference=False) == _opts(ref.options,
                                                        reference=True)
    teng = tapi.TriangleEngine(profile=got, device=CPU)
    jeng = japi.TriangleEngine(profile=ref)
    assert teng.budgets == got.grid
    for tc, jc in zip(got.cells, ref.cells):
        tv = teng.options_for(tc.budget).plan_view(CPU)
        jv = jeng.options_for(jc.budget).plan_view()
        assert _opts(tv, reference=False) == _opts(jv, reference=True)
    assert {_budget(b): _meta(m) for b, m in teng._meta_ceiling.items()} == {
        _budget(b): _meta(m) for b, m in jeng._meta_ceiling.items()}
    # the same carried across from the parsed dict; the file is unchanged
    d = json.loads(before)
    assert ttune.profile_from_reference(d).to_json() == got.to_json()
    assert SERVE_MIX_PROFILE.read_bytes() == before
    # a backend the reference does not name is refused
    d["options"]["backend"] = "tpu"
    with pytest.raises(ValueError, match="reference backend"):
        ttune.profile_from_reference(d)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_profile_from_reference_maps_backend(backend):
    d = json.loads(SERVE_MIX_PROFILE.read_text())
    d["options"] = dict(d["options"], backend=backend, interpret=True)
    d["cells"][0]["options"] = dict(d["cells"][0]["options"],
                                    backend=backend)
    got = ttune.profile_from_reference(d)
    assert got.options.backend == got.cells[0].options.backend == \
        BACKEND[backend]
    # the port's own loader refuses the reference's interpret field
    with pytest.warns(UserWarning, match="unusable tuned profile"):
        assert ttune.load_profile(str(SERVE_MIX_PROFILE)) is None


_CORRUPT = [
    "not json {",
    json.dumps({"version": 999, "signature": "x", "options": {},
                "grid": {}}),
    json.dumps({"version": 1, "signature": "x",
                "options": {"no_such_knob": 1},
                "grid": {"min_nodes": 64, "min_slots": 256}}),
    json.dumps({"version": 1}),
    None,  # a missing file
]


@pytest.mark.parametrize("payload", range(len(_CORRUPT)))
def test_corrupt_profile_degrades_with_warning(tmp_path, payload):
    p = tmp_path / "bad.json"
    if _CORRUPT[payload] is not None:
        p.write_text(_CORRUPT[payload])
    for load in (ttune.load_profile, jtune.load_profile):
        with pytest.warns(UserWarning, match="unusable tuned profile"):
            assert load(str(p)) is None
    with pytest.warns(UserWarning, match="unusable tuned profile"):
        engine = tapi.TriangleEngine(profile=str(p), device=CPU)
    assert engine.profile is None
    assert engine.budgets == tcsr.DEFAULT_BUDGET_GRID
    assert engine.options == tapi.TCOptions()
    server = engine.serve(prewarm=True)  # nothing to prewarm
    server.submit(*gen.complete(6))
    assert [r.triangles for r in server.drain()] == [20]


def test_resolution_order_matches_reference(mini):
    _, t, j = mini
    tp, jp = _tiny_profile(t, _PORT), _tiny_profile(j, _REF)
    out = []
    for api_, prof, kw in ((tapi, tp, dict(device=CPU)), (japi, jp, {})):
        eng = api_.TriangleEngine(profile=prof, **kw)
        cell = prof.cells[0].budget
        far = type(cell)(1 << 20, 1 << 22)
        # explicit options outrank the profile default but not the cells
        eng2 = api_.TriangleEngine(api_.TCOptions(row_mult=128),
                                   profile=prof, **kw)
        grid = type(prof.grid)(min_nodes=32, min_slots=128)
        eng3 = api_.TriangleEngine(api_.TCOptions(grid=grid), profile=prof,
                                   **kw)
        eng4 = api_.TriangleEngine(profile=prof,
                                   budgets=type(prof.grid)(), **kw)
        out.append((
            eng.options.row_mult, eng.options.bucket_widths,
            dataclasses.asdict(eng.budgets),
            eng.options_for(cell).row_mult, eng2.options.row_mult,
            eng2.options_for(cell).row_mult, eng2.options_for(far).row_mult,
            dataclasses.asdict(eng3.budgets),
            dataclasses.asdict(eng4.budgets),
            {_budget(b): _meta(m) for b, m in eng2._meta_ceiling.items()},
        ))
    assert out[0] == out[1]
    assert out[0][:2] == (16, (8, 64)) and out[0][4:7] == (128, 16, 128)


# -------------------------------------------------------------- sweep
@pytest.mark.parametrize("smoke", [True, False])
def test_default_space_matches_reference(smoke):
    t = tsweep.default_space(smoke=smoke, device=CPU)
    j = jsweep.default_space(smoke=smoke)
    assert [c.label for c in t] == [
        c.label.replace("backend:jnp", "backend:torch") for c in j]
    for tc, jc in zip(t, j):
        assert _opts(tc.options, reference=False) == _opts(
            jc.options, reference=True)
        assert dataclasses.asdict(tc.grid) == dataclasses.asdict(jc.grid)
    # on the CPU backend:torch is the default's resolved backend
    assert all(c.options.plan_view(CPU).backend == "torch" for c in t)
    # on a CUDA device the plain probe is never a candidate
    cuda = tsweep.default_space(smoke=smoke, device="cuda")
    assert [c.label for c in cuda] == [c.label for c in t
                                       if c.label != "backend:torch"]
    assert len(cuda) == len(t) - (0 if smoke else 1)


def test_check_identical_raises_on_mismatch():
    base = {"triangles": [1, 2, 3], "overflow": False}
    for check in (tsweep._check_identical, jsweep._check_identical):
        check({"triangles": [1, 2], "overflow": False}, base, "ok")
        with pytest.raises(AssertionError, match="changed request 1"):
            check({"triangles": [1, 9], "overflow": False}, base, "bad")
        with pytest.raises(AssertionError, match="overflow"):
            check({"triangles": [1], "overflow": True}, base, "ovf")
    with pytest.raises(tsweep.SweepMismatch):
        tsweep._check_identical({"triangles": [0], "overflow": False}, base,
                                "x")


def test_two_config_sweep_matches_reference_and_local_count(mini):
    _, t, j = mini
    tout = tsweep.successive_halving(
        [ttune.SweepConfig("default", tapi.TCOptions()),
         ttune.SweepConfig("rm16", tapi.TCOptions(row_mult=16))],
        t, rungs=(0.5, 1.0), device=CPU)
    jout = jsweep.successive_halving(
        [jtune.SweepConfig("default", japi.TCOptions()),
         jtune.SweepConfig("rm16", japi.TCOptions(row_mult=16))],
        j, rungs=(1.0,))
    assert tout["triangles"] == jout["triangles"]
    assert len(tout["triangles"]) == len(t)
    assert tout["winner"]["label"] in {"default", "rm16"}
    assert [h["requests"] for h in tout["history"]] == [4, 8]
    assert [len(h["evals"]) for h in tout["history"]] == [2, 1]
    assert tout["baseline"]["plan_hit"] == 1.0
    assert tout["baseline"]["overflow"] is False
    eng = tapi.TriangleEngine(device=CPU)
    assert [eng.count(r.request()).triangles for r in t] == tout["triangles"]
    with pytest.raises(ValueError, match="empty trace"):
        tsweep.successive_halving(tsweep.default_space(smoke=True,
                                                       device=CPU), [])
    with pytest.raises(ValueError, match="empty config space"):
        tsweep.successive_halving([], t)


def test_shedding_config_aborts_the_sweep(mini):
    _, t, _ = mini
    cfg = ttune.SweepConfig("shedding", tapi.TCOptions(
        admission_tokens=1, approx_on_overload=False))
    with pytest.raises(tsweep.SweepMismatch, match="not answered exactly"):
        tsweep.evaluate_config(cfg, t[:4], batch_size=4, device=CPU)


def test_build_profile_matches_reference(mini):
    _, t, j = mini
    for grid in ({}, dict(min_nodes=128, min_slots=1024, factor=4.0)):
        tp = ttune.build_profile(
            ttune.SweepConfig("w", tapi.TCOptions(bucket_widths=(8, 64)),
                              tcsr.BudgetGrid(**grid)), t,
            objective={"x": 1})
        jp = jtune.build_profile(
            jtune.SweepConfig("w", japi.TCOptions(bucket_widths=(8, 64)),
                              jcsr.BudgetGrid(**grid)), j,
            objective={"x": 1})
        td, jd = tp.to_json(), jp.to_json()
        for d in (jd["options"], *(c["options"] for c in jd["cells"])):
            d.pop("interpret")
        assert td == jd


# ------------------------------------------------------------ prewarm
def _cache_keys(engine, *, reference: bool) -> set:
    """An engine's plan-cache keys (budget, pooled meta, plan view) and
    plans, in the port's terms."""
    return {
        (_budget(budget), _meta(meta),
         tuple(sorted((k, v) for k, v in _opts(
             view, reference=reference).items() if k != "grid")),
         tuple(dataclasses.astuple(b) for b in plan.buckets),
         plan.query_chunk)
        for (budget, meta, view), plan in engine._plan_cache._d.items()
    }


def test_prewarm_replay_plan_hit_and_cache_keys_match_reference(mini,
                                                                tmp_path):
    _, t, j = mini
    tprof = ttune.build_profile(
        ttune.SweepConfig("default", tapi.TCOptions()), t)
    loaded = ttune.load_profile(tprof.save(str(tmp_path / "p.json")))
    rep = ttune.prewarm_replay(loaded, t, batch_size=4, device=CPU)
    assert rep["plan_hit"] == 1.0 and rep["jit_compiles"] == 0
    eng = tapi.TriangleEngine(device=CPU)
    assert rep["triangles"] == [eng.count(r.request()).triangles for r in t]
    # the prewarm's own plan-cache keys, beside a reference prewarm's
    teng = tapi.TriangleEngine(profile=loaded, device=CPU)
    tsrv = teng.serve(batch_size=4, prewarm=True)
    jprof = jtune.build_profile(
        jtune.SweepConfig("default", japi.TCOptions()), j)
    jeng = japi.TriangleEngine(profile=jprof)
    jeng.serve(batch_size=4, prewarm=True)
    tkeys = _cache_keys(teng, reference=False)
    assert tkeys == _cache_keys(jeng, reference=True)
    # every cell at every lane count of the ladder (1, 2, 4): one plan
    # key a cell, whatever the lane count
    ps = teng.plan_cache_stats()
    assert (ps["misses"], ps["hits"]) == (len(tprof.cells),
                                          2 * len(tprof.cells))
    assert len(tkeys) == len(tprof.cells) == 2
    s = tsrv.summary()
    assert (s["plan_hit"], s["jit_compiles"], s["batches"]) == (1.0, 0, 0)


def test_unwarmed_server_reports_plan_misses(mini):
    _, t, _ = mini
    server = tapi.TriangleEngine(device=CPU).serve()
    for rec in t:
        server.submit(*rec.request(), deadline_s=1e9)
    server.drain()
    s = server.summary()
    assert s["plan_hit"] < 1.0  # the cold path is cold
    assert s["jit_compiles"] == 0  # nothing loads on the CPU


def test_failing_recorder_is_warned_and_never_raised():
    class Broken:
        def record(self, **kw):
            raise OSError("disk full")

    for api_, kw in ((tapi, dict(device=CPU)), (japi, {})):
        srv = api_.TriangleEngine(**kw).serve(recorder=Broken())
        with pytest.warns(UserWarning, match="trace recorder failed on "
                                             "request 0: disk full"):
            rid = srv.submit(*gen.karate())
        assert [(r.request_id, r.triangles) for r in srv.drain()] == [
            (rid, 45)]
