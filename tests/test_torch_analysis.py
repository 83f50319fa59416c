"""The port's static auditor (``repro_torch.analysis``) held against the
reference's (``repro.analysis``) on the CPU: reports that load in either
package, the dead-code scan equal to the reference's on a tree, the op
recorder's sync census, the AST host-sync scan, the compile set of
``results/tuned/serve_mix.json`` equal to the reference's key for key
(and its census site to the reference baseline's), a prewarmed server's
plan cache and replay, the bounds at host and launch sites, the
collective census, the tally against the reference's, the synthetic
sync, collective and unpriced call that each dirty the baseline diff,
and ``run_audit()`` equal to the tracked baseline."""
from __future__ import annotations

import ctypes
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.analysis.deadcode as jdead
import repro.analysis.findings as jfind
import repro.api as japi
from repro.analysis.bounds import audit_host_sites as j_audit_host_sites
from repro.analysis.compile_set import enumerate_compile_keys as j_keys
from repro.analysis.routes import bounded_plan as j_bounded_plan
from repro.analysis.routes import synthetic_meta as j_synthetic_meta
from repro.core import comm_instrument as jcomm
from repro.tune import profile as jprofile
from repro_torch import api as tapi
from repro_torch.analysis import audit as taudit
from repro_torch.analysis import bounds as tbounds
from repro_torch.analysis import collectives as tcoll
from repro_torch.analysis import compile_set as tcs
from repro_torch.analysis import deadcode as tdead
from repro_torch.analysis import findings as tfind
from repro_torch.analysis import hostsync as thost
from repro_torch.analysis import routes as troutes
from repro_torch.analysis import walker as twalk
from repro_torch.core import comm_instrument as tcomm
from repro_torch.core.parallel_tc import _capacities
from repro_torch.core.shards import CollectiveCall
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as gen
from repro_torch.kernels.intersect import intersect as tk
from repro_torch.launch import serve_tc as tserve
from repro_torch.tune import profile as tprofile

CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]
#: the reference's tuned profile (read only)
SERVE_MIX = REPO / "results" / "tuned" / "serve_mix.json"
BASELINE = REPO / "results" / "AUDIT_torch_baseline.json"
REFERENCE_BASELINE = REPO / "results" / "AUDIT_baseline.json"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def baseline():
    return tfind.Report.load(str(BASELINE))


@pytest.fixture(scope="module")
def fresh():
    """One full ``run_audit()`` on this CPU."""
    return taudit.run_audit()


def _finding(site, pass_name="p", severity="info", **data):
    return tfind.Finding(pass_name=pass_name, site=site, severity=severity,
                         detail="d", data=data)


def _dist_specs(p_values=(1, 2, 4, 8)):
    return [s for s in troutes.enumerate_route_specs(p_values=p_values)
            if s.route == "distributed"]


# ------------------------------------------------------------- findings


def test_reports_load_across_packages(tmp_path):
    ours = tfind.Report(findings=[_finding("b", severity="warning", x=[1]),
                                  _finding("a")], meta={"torch": "t"})
    ours.save(str(tmp_path / "t.json"))
    theirs = jfind.Report.load(str(tmp_path / "t.json"))
    assert theirs.to_json() == ours.to_json()
    assert [f.site for f in ours.findings] == ["a", "b"]  # sorted
    jrep = jfind.Report(findings=[jfind.Finding("q", "s", "error", "d",
                                                {"k": 2})], meta={"jax": 1})
    jrep.save(str(tmp_path / "j.json"))
    back = tfind.Report.load(str(tmp_path / "j.json"))
    assert back.to_json() == jrep.to_json()
    assert back.counts() == {"error": 1, "warning": 0, "info": 0}
    # the reference's own tracked baseline loads in the port
    assert len(tfind.Report.load(str(REFERENCE_BASELINE)).findings) == len(
        jfind.Report.load(str(REFERENCE_BASELINE)).findings)


def test_duplicate_keys_and_newer_version_refused():
    for mod in (tfind, jfind):
        f = mod.Finding("p", "s", "info", "d")
        with pytest.raises(ValueError, match="duplicate"):
            mod.Report(findings=[f, f])
        with pytest.raises(ValueError, match="duplicate"):
            mod.merge_findings([f], [f])
        with pytest.raises(ValueError, match="version"):
            mod.Report.from_json({"version": mod.REPORT_VERSION + 1})
        with pytest.raises(ValueError, match="severity"):
            mod.Finding("p", "s", "fatal", "d")


def test_diff_directions_match_reference():
    a, b, c = (_finding(s) for s in "abc")
    base = tfind.Report(findings=[a, b])
    assert tfind.diff_reports(tfind.Report(findings=[b, a]), base).clean
    d = tfind.diff_reports(tfind.Report(findings=[a, c]), base)
    assert ([f.site for f in d.new], [f.site for f in d.fixed]) == (["c"],
                                                                    ["b"])
    jd = jfind.diff_reports(
        jfind.Report(findings=[jfind.Finding.from_json(f.to_json())
                               for f in (a, c)]),
        jfind.Report(findings=[jfind.Finding.from_json(f.to_json())
                               for f in (a, b)]))
    assert ([f.site for f in jd.new], [f.site for f in jd.fixed]) == (
        ["c"], ["b"])
    text = d.render()
    assert "python -m repro_torch.analysis.audit" in text
    assert "results/AUDIT_torch_baseline.json" in text
    assert tfind.finding_data(t=(1, np.int64(2)), d={1: np.int32(3)}) == {
        "t": [1, 2], "d": {"1": 3}}


# ------------------------------------------------------------- dead code

_TREE = {
    "a.py": ("X_CONST = 1\n_private = 2\nlower_var = 3\nY: int = 4\n"
             "def dead():\n    pass\n\ndef alive():\n    pass\n"
             "def internal():\n    pass\n\ndef caller():\n"
             "    return internal()\n\nclass Thing:\n    pass\n"
             "def _hidden():\n    pass\n"),
    "b.py": "from PKG.a import alive\nalive()\nY + 1\n",
    "sub/c.py": "def lonely():\n    pass\n\nclass Used:\n    pass\n",
    "sub/d.py": "# mentions Used in a comment\n",
}


def _write_tree(root: Path, pkg: str):
    for rel, text in _TREE.items():
        p = root / "src" / pkg / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text.replace("PKG", pkg))


def test_public_symbols_match_reference(tmp_path):
    _write_tree(tmp_path, "repro_torch")
    for rel in _TREE:
        path = tmp_path / "src" / "repro_torch" / rel
        assert tdead.public_symbols(path) == jdead.public_symbols(path)
    assert tdead.public_symbols(
        tmp_path / "src" / "repro_torch" / "a.py") == [
        "X_CONST", "Y", "dead", "alive", "internal", "caller", "Thing"]


def test_unused_scan_matches_reference(tmp_path):
    _write_tree(tmp_path, "repro")
    _write_tree(tmp_path, "repro_torch")
    ours = tdead.find_unused_symbols(tmp_path)
    theirs = jdead.find_unused_symbols(tmp_path)
    assert [(u["module"].replace("repro_torch.", ""), u["symbol"])
            for u in ours] == [
        (u["module"].replace("repro.", ""), u["symbol"]) for u in theirs]
    assert {u["symbol"] for u in ours} == {"dead", "caller", "X_CONST",
                                           "Thing", "lonely"}
    # chip_smoke.py is a reference of the port (as examples/ and
    # benchmarks/ are of the reference); tests are not
    (tmp_path / "chip_smoke.py").write_text("from x import lonely\n")
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "t.py").write_text("dead()\n")
    assert {u["symbol"] for u in tdead.find_unused_symbols(tmp_path)} == {
        "dead", "caller", "X_CONST", "Thing"}


# ------------------------------------------------------------- walker


def test_op_recorder_counts_toy_syncs():
    x = torch.arange(10)
    mask = x % 3 == 0
    with twalk.OpRecorder() as rec:
        with rec.scope("toy"):
            a = x.sum().item()
            b = bool((x > 3).any())
            c = int(x[3])
            nz = x.nonzero()
            sel = x[mask]
            ms = torch.masked_select(x, mask)
            u = torch.unique(x)
            rep = torch.repeat_interleave(x[:3], x[:3])
        y = (x + 1) * 2  # no sync
    assert (a, b, c, nz.shape[0], sel.tolist(), ms.shape[0], u.shape[0],
            rep.tolist()) == (45, True, 3, 9, [0, 3, 6, 9], 4, 10, [1, 2, 2])
    assert twalk.op_counts(twalk.sync_ops(rec.record)) == {
        "_local_scalar_dense": 3, "nonzero": 1, "index[bool]": 1,
        "masked_select": 1, "_unique2": 1, "repeat_interleave": 1}
    assert all(s.scope == ("toy",) for s in twalk.sync_ops(rec.record))
    add = [s for s in rec.record if s.op == "add"]
    assert add and add[-1].scope == () and add[-1].shapes == ((10,),)
    assert add[-1].dtypes == ("int64",) and y.shape == (10,)
    # a sized repeat_interleave knows its output: not a sync
    with twalk.OpRecorder() as rec:
        torch.repeat_interleave(x[:3], x[:3], output_size=3)
    assert twalk.sync_ops(rec.record) == []


def test_ast_sync_counting_toy():
    def hot(x):
        torch.cuda.synchronize()
        v = x.cpu().numpy()
        return int(x.sum().item()) + len(x.tolist()) + int(v[0])

    assert thost._sync_calls("toy.hot", hot) == {
        "synchronize": 1, "cpu": 1, "numpy": 1, "item": 1, "tolist": 1}


def test_sanctioned_sync_sets_equal_the_baseline(baseline):
    """The AST sites of the hot path and every route's runtime census are
    exactly the tracked baseline's: the BFS's one ``.item()`` a sweep,
    the exact plan's read-backs, K2's chunking and the finalize."""
    ast_sites = {f.site for f in thost.audit_hot_path_syncs()}
    assert ast_sites == {f.site for f in baseline.findings
                         if f.site.startswith("ast:")}
    assert "ast:repro_torch.core.bfs.bfs_levels_iters:item:x1" in ast_sites
    assert "ast:TriangleServer._finalize_one:cpu:x3" in ast_sites
    single = troutes.enumerate_route_specs(p_values=(1,))
    census = thost.audit_route_syncs(single)
    assert {f.site for f in census} == {
        f.site for f in baseline.findings
        if f.pass_name == "hostsync" and f.site.startswith("census:")}
    # the BFS reads its flag back once a sweep: the batch route's only
    # scalar syncs are its sweeps, the local route's its sweeps and n_h
    by = {(f.data["route"], f.data["op"]): f.data for f in census}
    batch = by[("batch/torch", "_local_scalar_dense")]
    assert batch["count"] == batch["bfs_sweeps"] > 0
    local = by[("local/torch", "_local_scalar_dense")]
    assert local["count"] == local["bfs_sweeps"] + 1


def test_synthetic_new_sync_dirties_baseline(baseline):
    """A new ``.item()`` on a hot-path function, and a new sync op in a
    route's run, each add a key the baseline lacks."""
    ast_base = tfind.Report(findings=thost.audit_hot_path_syncs())

    def _flush(self):
        return self.x.item()

    injected = thost.hot_path_callables() + [("TriangleServer.toy",
                                              _flush)]
    d = tfind.diff_reports(
        tfind.Report(findings=thost.audit_hot_path_syncs(injected)),
        ast_base)
    assert not d.clean and [f.site for f in d.new] == [
        "ast:TriangleServer.toy:item:x1"]
    spec = troutes.enumerate_route_specs()[0]
    record, sweeps = thost.record_route(spec)
    with twalk.OpRecorder() as rec:
        bool(torch.ones(1).any())  # one more scalar read-back
    fresh = tfind.Report(findings=[
        f for f in baseline.findings if not f.site.startswith(
            f"census:{spec.name}:")] + thost.census_findings(
        spec.name, record + rec.record, sweeps))
    d = tfind.diff_reports(fresh, baseline)
    assert not d.clean and len(d.new) == len(d.fixed) == 1


# ------------------------------------------------------------ compile set


def _serve_mix_engines():
    teng = tapi.TriangleEngine(
        device=CPU, profile=tprofile.profile_from_reference(str(SERVE_MIX)))
    jeng = japi.TriangleEngine(profile=jprofile.load_profile(str(SERVE_MIX)))
    return teng, jeng


def _plan_fields(plan):
    return (tuple(dataclasses.astuple(b) for b in plan.buckets),
            plan.query_chunk, plan.sort_queries, plan.total_rows,
            plan.probe_rows, plan.probe_cells, plan.peak_rows)


@pytest.mark.parametrize("batch_size", [8, 2, 1])
def test_compile_keys_equal_reference(batch_size):
    teng, jeng = _serve_mix_engines()
    ours = teng.compile_space(batch_size=batch_size)
    theirs = j_keys(jeng, batch_size=batch_size)
    assert len(ours) == len(theirs) > 0
    for t, j in zip(ours, theirs):
        assert (t.budget.n_budget, t.budget.slot_budget, t.lanes, t.root,
                t.per_vertex) == (j.budget.n_budget, j.budget.slot_budget,
                                  j.lanes, j.root, j.per_vertex)
        assert _plan_fields(t.plan) == _plan_fields(j.plan)
        assert t.plan.backend == "torch" and j.plan.backend == "jnp"
    assert tcs.predicted_jit_compiles(teng, batch_size=batch_size) == len(
        theirs)
    # enumeration touches neither plan cache's entries nor its stats
    assert teng.plan_cache_stats()["size"] == 0
    assert teng.plan_cache_stats()["misses"] == 0


def test_census_site_equals_reference_baseline():
    teng, _ = _serve_mix_engines()
    sites = {f.site for f in tcs.audit_compile_set(
        teng, batch_size=8, label="serve_mix.json")}
    ref = {f.site for f in jfind.Report.load(
        str(REFERENCE_BASELINE)).findings if f.pass_name == "compile_set"}
    assert sites == ref == {"census:serve_mix.json:b8:jit32:plan8",
                            "unbounded-grid:serve_mix.json"}
    capped = tapi.TriangleEngine(
        device=CPU, budgets=tcsr.BudgetGrid(max_nodes=512, max_slots=8192),
        profile=tprofile.profile_from_reference(str(SERVE_MIX)))
    assert [f.site for f in tcs.audit_compile_set(
        capped, batch_size=8, label="c")] == ["census:c:b8:jit32:plan8"]


def test_profileless_engine_has_empty_compile_set():
    eng = tapi.TriangleEngine(device=CPU)
    assert eng.compile_space() == [] == tcs.plan_cache_keys(eng)
    assert tcs.predicted_jit_compiles(eng) == 0
    assert [f.site for f in tcs.audit_compile_set(eng, label="x")] == [
        "unbounded-grid:x", "census:x:b8:jit0:plan0"]


def _recorded_profile():
    """A profile frozen from a small trace (the reference test's mix)."""
    from repro_torch.tune import TraceRecorder, build_profile
    from repro_torch.tune.sweep import SweepConfig

    eng = tapi.TriangleEngine(device=CPU)
    reqs = [gen.complete(5 + i % 3) if i % 3 == 2 else
            gen.erdos_renyi(20 + 6 * i, 0.15, seed=100 + i)
            for i in range(6)]
    with TraceRecorder() as rec:
        srv = eng.serve(batch_size=2, recorder=rec)
        for e, n in reqs:
            srv.submit(e, n, deadline_s=1e9)
        srv.drain()
    return build_profile(SweepConfig("prop", eng.options),
                         list(rec.records)), reqs


@pytest.mark.parametrize("which", ["serve_mix", "recorded"])
def test_prewarmed_server_runs_exactly_the_compile_set(which):
    """The prewarm runs one warm batch a compile key, key for key; the
    plan cache then holds exactly the enumerated plan keys (one a cell:
    the cache is keyed without the lane count); a replay of covered
    traffic hits a cached plan every time and loads nothing."""
    if which == "serve_mix":
        profile = tprofile.profile_from_reference(str(SERVE_MIX))
        batch_size = 8
        reqs = tserve.synth_requests(96, seed=0)
    else:
        profile, reqs = _recorded_profile()
        batch_size = 2
    eng = tapi.TriangleEngine(device=CPU, profile=profile)
    keys = eng.compile_space(batch_size=batch_size)
    ran = []
    real = eng.count_batch_raw

    def count_batch_raw(gb, *, options=None, plan=None, clock=None):
        o = options or eng.options
        ran.append(tcs.CompileKey(gb.budget, gb.batch_size, plan,
                                  int(o.root), bool(o.per_vertex)))
        return real(gb, options=options, plan=plan, clock=clock)

    eng.count_batch_raw = count_batch_raw
    srv = eng.serve(batch_size=batch_size, prewarm=True)
    assert ran == keys and len(ran) == tcs.predicted_jit_compiles(
        eng, batch_size=batch_size)
    cached = eng._plan_cache.keys()
    assert set(cached) == set(tcs.plan_cache_keys(eng))
    assert len(cached) == len({(k.budget, k.plan) for k in keys}) == len(
        [c for c in profile.cells if c.meta is not None])
    cells = {c.budget: c.meta for c in profile.cells if c.meta is not None}
    covered = []
    for e, n in reqs:
        b = eng.budgets.budget_for(n, np.asarray(e).reshape(-1, 2).shape[0])
        if b in cells and cells[b].union(tcsr.degree_meta(e, n)) == cells[b]:
            covered.append((e, n))
    assert len(covered) >= 6
    for e, n in covered:
        srv.submit(e, n)
    res = {r.request_id: r.triangles for r in srv.drain()}
    s = srv.summary()
    assert (s["plan_hit"], s["jit_compiles"]) == (1.0, 0)
    plain = tapi.TriangleEngine(device=CPU)
    assert [res[i] for i in range(len(covered))] == [
        plain.count(g).triangles for g in covered]


# ------------------------------------------------------------- bounds


def test_host_bounds_hold_reference_keys():
    ours = {f.site for s in tbounds.DEFAULT_SCALES
            for f in tbounds.audit_host_sites(s)}
    theirs = {f.site for s in tbounds.DEFAULT_SCALES
              for f in j_audit_host_sites(s)}
    assert theirs == {"host:from_edges:row_offsets@scale26",
                      "host:from_edges:row_offsets@scale36",
                      "host:from_edges:vertex-ids@scale36"}
    assert {s for s in ours if s.startswith("host:from_edges:")} == theirs
    # the lane view multiplies by its lanes: it crosses int32 earlier
    data = {f.site: f.data for f in tbounds.audit_host_sites(36)}
    lane = data["host:GraphBatch[b8]:lane-slots@scale36"]["first_scale"]
    single = data["host:from_edges:row_offsets@scale36"]["first_scale"]
    assert (lane, single) == (23, 26)
    assert not tbounds.audit_host_sites(20)


def test_host_sites_cover_every_policy_call(tmp_path):
    assert sorted(tbounds.policy_sites()) == sorted(
        s.policy_site for s in tbounds.HOST_SITES)
    assert tbounds.audit_site_coverage() == []
    toy = tmp_path / "csr.py"
    toy.write_text(Path(tcsr.__file__).read_text() + (
        "\ndef new_site(n):\n"
        "    torch_index_dtype(n, site='csr.new_site ids')\n"))
    (f,) = tbounds.audit_site_coverage(toy)
    assert (f.site, f.severity) == ("host:unbounded-site:csr.new_site ids",
                                    "error")


def test_synthetic_meta_and_bounded_plan_match_reference():
    for nb, sb in ((64, 256), (128, 4096), (1 << 20, 1 << 25)):
        for d_pad in (None, 1024):
            tm = troutes.synthetic_meta(nb, sb, d_pad=d_pad)
            jm = j_synthetic_meta(nb, sb, d_pad=d_pad)
            assert (tm.d_pad, tm.h_rows, tm.exceed) == (jm.d_pad, jm.h_rows,
                                                        jm.exceed)
            assert _plan_fields(troutes.bounded_plan(tm)) == _plan_fields(
                j_bounded_plan(jm))


def test_launch_table_covers_every_c_int():
    """Every ``c_int`` position of every kernel's ``_ARGTYPES`` has a
    bound (a new ``c_int`` argument without one fails here), and every
    guard the table names really refuses a value past int32 — ctypes
    alone would truncate it to 0 without a word."""
    for name, types in tk._ARGTYPES.items():
        ints = {i for i, t in enumerate(types) if t is ctypes.c_int}
        assert set(tbounds.LAUNCH_ARGS[name]) == ints, name
        assert all(g for _, _, g in tbounds.LAUNCH_ARGS[name].values())
    assert set(tbounds.INT32_OPERANDS) == set(tk._ARGTYPES)
    assert ctypes.c_int(2**40).value == 0
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="exceed int32"):
        tk.item_layout(x, x, x, x, d_cand=2**31, d_targ=8, path="bitmap")
    rows = tbounds.launch_table(20)
    assert {(r["kernel"], r["position"]) for r in rows
            if r["position"] is not None} == {
        (k, i) for k, a in tbounds.LAUNCH_ARGS.items() for i in a}


@pytest.mark.parametrize("scale", tbounds.DEFAULT_SCALES)
def test_launch_sites_by_scale(scale):
    sites = {f.site: f for f in tbounds.audit_launch_sites(scale)}
    ctx = tbounds.LaunchContext.at(scale)
    assert all(f.severity == "warning" for f in sites.values())
    if scale == 20:
        # every launch argument fits; a lane's summed c1 bound does not
        assert set(sites) == {"launch:intersect_levels:c1@scale20",
                              "launch:intersect_levels:c2@scale20",
                              "launch:intersect_count:cnt@scale20"}
        assert ctx.q < 2**31 and ctx.lane_cells > 2**31 - 1
    if scale == 26:
        assert "launch:intersect_levels:q@scale26" in sites
        assert "launch:intersect_levels:s_s@scale26" in sites
        assert "launch:intersect_levels:flat@scale26" not in sites
    if scale == 36:
        assert "launch:intersect_levels:flat@scale36" in sites
        assert "launch:intersect_levels:d_cand@scale36" not in sites


# ------------------------------------------------------------ collectives


@pytest.fixture(scope="module")
def dist_findings():
    return tcoll.audit_collectives(_dist_specs())


@pytest.mark.parametrize("mode", ["allgather", "ring"])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_per_vertex_adds_exactly_one_reduce(dist_findings, mode, p):
    census = {f.site.split(":")[1]: f.data for f in dist_findings
              if f.site.startswith("census:")}
    plain = census[f"distributed/torch/{mode}/p{p}"]
    pv = census[f"distributed/torch/pv/{mode}/p{p}"]
    assert pv["count"] == plain["count"] + 1
    assert pv["by_phase"]["reduce"] == plain["by_phase"]["reduce"] + 1
    assert {k: v for k, v in pv["by_phase"].items() if k != "reduce"} == {
        k: v for k, v in plain["by_phase"].items() if k != "reduce"}
    # allgather: the reference's 13 (14 with credit); ring: p - 1 rounds
    # of two ppermutes each
    hedge = 2 if mode == "allgather" else 2 * (p - 1)
    assert plain["count"] == 11 + hedge


def test_measured_equals_tally_in_every_spec(dist_findings):
    sites = [f.site for f in dist_findings]
    assert not [s for s in sites if not s.startswith("census:")]
    assert len(sites) == 16
    for f in dist_findings:
        assert f.data["measured"] == f.data["tally"]
        assert f.data["bfs_sweeps"] > 0


@pytest.mark.parametrize("mode", ["allgather", "ring"])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("per_vertex", [False, True])
@pytest.mark.parametrize("frontier_dtype", ["int32", "uint8"])
def test_tally_equals_reference(mode, p, per_vertex, frontier_dtype):
    _, cap_chunk, cap_hedge = _capacities(156, p, 4.0)
    kw = dict(n=64, p=p, cap_chunk=cap_chunk, cap_hedge=cap_hedge,
              mode=mode, frontier_dtype=frontier_dtype, sweeps=4,
              per_vertex=per_vertex)
    ours = tcomm.tally_comm(**kw).phase_bytes()
    theirs = {k: int(v) for k, v in jcomm.tally_comm(**kw)
              .phase_bytes().items()}
    assert ours == theirs


def test_census_digest_folds_the_bfs_loop():
    def call(kind, n, in_bfs=False, shape=(4,)):
        return CollectiveCall(kind=kind, shape=shape, dtype="int32",
                              nbytes=n, in_bfs=in_bfs)

    head = [call("pmax", 256, shape=(64,))]
    sweep = [call("pmax", 256, True, shape=(64,))]
    tail = [call("all_gather", 16), call("all_to_all", 64, shape=(2, 8)),
            call("psum", 4, shape=())]

    def digest(sweeps):
        calls = head + sweep * sweeps + tail
        folded = tcoll.fold_bfs(calls, sweeps)
        return len(folded), tcoll.census_digest(
            folded, tcoll._phases([c for c, _ in folded], 64, 2))

    assert digest(3) == digest(7) == (5, digest(1)[1])
    with pytest.raises(ValueError):
        tcoll.fold_bfs(head + sweep * 3 + tail, 2)


def _one_run(spec):
    res = spec.run(CPU)
    _, cap_chunk, cap_hedge = _capacities(tcoll._edge_slots(spec), spec.p,
                                          4.0)
    kw = dict(sweeps=int(res.comm.bfs_sweeps), n=spec.n_budget, p=spec.p,
              mode=spec.mode, cap_chunk=cap_chunk, cap_hedge=cap_hedge,
              per_vertex=spec.per_vertex)
    return list(res.collectives), kw


def test_synthetic_new_collective_dirties_baseline(baseline):
    """An injected collective re-keys the route's census and breaks the
    tally; both are new keys, so ``--check`` exits non-zero."""
    spec = next(s for s in _dist_specs((4,)) if s.mode == "allgather")
    calls, kw = _one_run(spec)
    clean = tcoll.audit_run_collectives(spec.name, calls, **kw)
    assert {f.site for f in clean} <= {f.site for f in baseline.findings}
    extra = CollectiveCall(kind="psum", shape=(), dtype="int32", nbytes=4)
    dirty = tcoll.audit_run_collectives(spec.name, calls + [extra], **kw)
    d = tfind.diff_reports(tfind.Report(findings=dirty),
                           tfind.Report(findings=clean))
    assert not d.clean
    assert {f.site.split(":")[0] for f in d.new} == {"census",
                                                     "tally-mismatch"}
    # a kind the wire model has no price for is reported outright
    odd = CollectiveCall(kind="reduce_scatter", shape=(4,), dtype="int32",
                         nbytes=16)
    sites = [f.site for f in tcoll.audit_run_collectives(
        spec.name, calls + [odd], **kw)]
    assert f"unpriced:{spec.name}:reduce_scatter" in sites


def test_unpriced_call_in_toy_module_dirties_baseline(tmp_path):
    toy = tmp_path / "toy_tc.py"
    toy.write_text(
        "import torch\nimport torch.distributed as dist\n"
        "from torch.distributed import all_reduce as ar\n\n"
        "def body(x):\n    dist.all_reduce(x)\n"
        "    torch.distributed.broadcast(x, 0)\n    ar(x)\n\n"
        "class GroupShards:\n    def ok(self, x):\n"
        "        self._dist.all_reduce(x)\n        dist.barrier()\n")
    assert tcoll.unpriced_calls(tcoll.shard_body_paths()) == []
    assert tcoll.unpriced_calls([toy]) == [
        "toy_tc:body:dist.all_reduce",
        "toy_tc:body:torch.distributed.broadcast", "toy_tc:body:ar"]
    labels = [s.name for s in _dist_specs((2,))]
    base = tfind.Report(findings=tcoll.audit_unpriced(labels))
    fresh = tfind.Report(findings=tcoll.audit_unpriced(
        labels, tcoll.shard_body_paths() + [toy]))
    d = tfind.diff_reports(fresh, base)
    assert not d.clean and len(d.new) == 3 * len(labels)
    assert all(f.severity == "error" for f in d.new)


# --------------------------------------------------------------- routes


def test_route_space_matches_reference_names():
    from repro.analysis.routes import enumerate_route_specs as j_specs

    ours = [s.name for s in troutes.enumerate_route_specs(p_values=(1, 4))]
    theirs = [s.name.replace("/jnp", "/torch")
              for s in j_specs(p_values=(1, 4)) if "/pallas" not in s.name]
    assert ours == theirs and len(ours) == 15


def test_routes_answer_the_plain_counts():
    """Each audited route's answer on the pinned graphs is the plain
    count (karate 45 and its finding, the batch lanes' own counts, the
    distributed route at every shard count)."""
    (ke, kn), (ee, en) = troutes.route_graphs()
    specs = {s.name: s for s in troutes.enumerate_route_specs(
        p_values=(1, 8))}
    plain = tapi.TriangleEngine(device=CPU)
    want = [plain.count((ke, kn)).triangles, plain.count((ee, en)).triangles]
    assert want[0] == 45
    res = specs["batch/torch"].run()
    assert res.triangles.tolist() == want
    assert int(specs["local/torch/pv"].run().per_vertex.sum()) == 3 * 45
    tri, cnt = specs["find/torch"].run()
    assert int(cnt) == 45 and (tri[:45] >= 0).all()
    for name in ("distributed/torch/ring/p8",
                 "distributed/torch/pv/allgather/p8"):
        assert int(specs[name].run().triangles) == 45
    total, _ = specs["stream/torch"].run()
    assert total > 0


# ---------------------------------------------------------------- audit


def test_run_audit_equals_tracked_baseline(fresh, baseline):
    d = tfind.diff_reports(fresh, baseline)
    assert d.clean, d.render()
    assert {f.pass_name for f in fresh.findings} == {
        "bounds", "collectives", "compile_set", "deadcode", "hostsync"}
    assert fresh.meta["predicted_jit_compiles"] == 32
    assert fresh.meta["p_values"] == [1, 2, 4, 8]
    assert fresh.meta["route_programs"] == baseline.meta["route_programs"]
    assert fresh.counts()["error"] == 0


def test_cli_check_and_write(tmp_path, capsys, baseline):
    out = tmp_path / "fresh.json"
    assert taudit.main(["--check", str(BASELINE), "--out", str(out),
                        "--p-max", "8"]) == 0
    assert "baseline check OK" in capsys.readouterr().out
    assert json.loads(out.read_text())["findings"] == [
        f.to_json() for f in tfind.Report.load(str(out)).findings]
    short = tmp_path / "short.json"
    tfind.Report(findings=baseline.findings[1:], meta=baseline.meta).save(
        str(short))
    assert taudit.main(["--check", str(short), "--p-max", "1"]) == 1
    text = capsys.readouterr().out
    assert "NEW finding" in text and "no longer reported" in text
