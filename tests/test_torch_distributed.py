"""The port's distributed route (Algorithm 2) held against the JAX
package on the CPU, bit for bit.

The reference runs once, in a subprocess with eight forced host devices
(the flag must precede its first jax import), over karate,
``ring_of_cliques(5, 6)``, ``erdos_renyi(200, 0.05, seed=3)``,
``rmat(8, 8, seed=1)`` and ``rmat(10, 16, seed=0)`` at p = 1, 2, 4 and 8
in both hedge modes (per-vertex credit on rmat10), plus the units that
need a mesh: regular sampling and the transpose, the sharded BFS and the
parallel wedge baseline.  The port runs the same inputs over
``LocalShards(p, "cpu")``: triangles, ``per_device``, ``recv_counts``,
``k``, ``num_horizontal``, both overflow flags, ``comm.phase_bytes()``
and the credit must be equal, and every count equal to the NumPy
oracle.  The host-side units (``shard_edges``, ``plan_hedge_rounds``,
``PairListAdjacency``, a ``sort_queries`` plan) are compared in this
process.  ``comm_report``'s measured (the shard group's call record) ==
tally == modeled, per phase; ``GroupShards`` over 2 and 4 gloo ranks
equals ``LocalShards``; and the server answers over-budget requests on
the route, with its timeouts, retries and fault classes.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import intersect as jint
from repro.core import parallel_tc as jptc
from repro.graph import csr as jcsr
from repro.graph import partition as jpart
from repro_torch import api as tapi
from repro_torch.core import bfs as tbfs
from repro_torch.core import comm_instrument as tci
from repro_torch.core import comm_model as tcm
from repro_torch.core import edges as tedges
from repro_torch.core import intersect as tint
from repro_torch.core import parallel_tc as tptc
from repro_torch.core import sampling as tsamp
from repro_torch.core import wedge_baseline as twedge
from repro_torch.core.shards import LocalShards
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as gen
from repro_torch.graph import partition as tpart
from repro_torch.launch import robust as trobust
from tests import oracle

CPU = "cpu"
SRC = os.path.join(os.path.dirname(__file__), "..", "src")

CASES = {
    "karate": "gen.karate()",
    "ring": "gen.ring_of_cliques(5, 6)",
    "er": "gen.erdos_renyi(200, 0.05, seed=3)",
    "rmat8": "gen.rmat(8, 8, seed=1)",
    "rmat10": "gen.rmat(10, 16, seed=0)",
}
GRAPHS = {name: eval(expr) for name, expr in CASES.items()}
PS = (1, 2, 4, 8)
MODES = ("allgather", "ring")
#: per-vertex runs of the reference: (case, p, mode)
PV_RUNS = (("rmat10", 2, "allgather"), ("rmat10", 8, "allgather"),
           ("rmat10", 8, "ring"))
#: the transpose's fixed input: per-shard length, valid share, cap_chunk
SPLIT_LEN, SPLIT_CAPS = 64, (16, 9)

#: the values the reference gives at p = 8 (both modes)
PINNED = {
    "karate": dict(
        triangles=45, per_device=[23, 2, 3, 3, 5, 1, 6, 2],
        recv_counts=[25, 13, 14, 13, 15, 15, 21, 12],
        comm={"bfs": 9520, "splitter": 1792, "transpose": 4480,
              "hedge": 8960, "reduce": 336}),
    "rmat10": dict(
        triangles=75682,
        per_device=[16211, 13498, 11354, 9760, 9010, 9223, 3720, 2906],
        recv_counts=[2112, 1050, 1491, 1515, 1345, 1771, 1347, 2178],
        comm={"bfs": 344064, "splitter": 1792, "transpose": 586880,
              "hedge": 1173312, "reduce": 336}),
}
PINNED_PV_REDUCE = 57680  # rmat10, p = 8, per_vertex

_REF_SCRIPT = """
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.api import TriangleEngine, TCOptions
from repro.compat import shard_map
from repro.core.bfs import bfs_levels
from repro.core.sampling import repartition_by_value
from repro.core.wedge_baseline import parallel_wedge_triangle_count
from repro.graph import generators as gen
from repro.graph.csr import from_edges
from repro.graph.partition import shard_edges

out = {}
devs = np.array(jax.devices())
meshes = {p: Mesh(devs[:p].reshape(p), ("p",)) for p in PS}
for name, expr in CASES.items():
    g = from_edges(*eval(expr))
    for p in PS:
        eng = TriangleEngine(mesh=meshes[p])
        runs = [(mode, False) for mode in MODES]
        runs += [(m, True) for c, q, m in PV_RUNS if c == name and q == p]
        for mode, pv in runs:
            r = eng.count_distributed_raw(
                g, options=TCOptions(mode=mode, per_vertex=pv))
            key = f"{name}/{p}/{mode}/{int(pv)}"
            out[key + "/ints"] = np.array([
                int(r.triangles), int(r.num_horizontal),
                int(r.transpose_overflow), int(r.hedge_overflow),
                int(r.comm.bfs_sweeps)], np.int64)
            out[key + "/k"] = np.asarray(r.k, np.float32)
            out[key + "/per_device"] = np.asarray(r.per_device)
            out[key + "/recv_counts"] = np.asarray(r.recv_counts)
            out[key + "/comm"] = np.array(
                [r.comm.phase_bytes()[ph] for ph in PHASES], np.int64)
            if pv:
                out[key + "/per_vertex"] = np.asarray(r.per_vertex)

# the transpose on one fixed input at p = 8
p = 8
rng = np.random.default_rng(7)
vals = rng.integers(0, 500, size=(p, SPLIT_LEN)).astype(np.int32)
carry = rng.integers(0, 500, size=(p, SPLIT_LEN)).astype(np.int32)
valid = rng.random((p, SPLIT_LEN)) < 0.7
vals[~valid] = 501
for cap in SPLIT_CAPS:
    def body(v, c, ok, cap=cap):
        rep = repartition_by_value(v, c, ok, p, cap, "p", inf=501)
        # the replicated outputs go out per shard (row 0 is read)
        return (rep.values, rep.carry, rep.count.reshape(1),
                rep.overflow.reshape(1), rep.splitters[None])
    fn = shard_map(body, mesh=meshes[p], in_specs=(P("p"),) * 3,
                   out_specs=(P("p"),) * 5)
    rv, rc, cnt, ovf, spl = jax.jit(fn)(
        jnp.asarray(vals.reshape(-1)), jnp.asarray(carry.reshape(-1)),
        jnp.asarray(valid.reshape(-1)))
    out[f"split/{cap}/values"] = np.asarray(rv).reshape(p, -1)
    out[f"split/{cap}/carry"] = np.asarray(rc).reshape(p, -1)
    out[f"split/{cap}/count"] = np.asarray(cnt)
    out[f"split/{cap}/overflow"] = np.asarray(ovf)[:1]
    out[f"split/{cap}/splitters"] = np.asarray(spl)[0]

# the sharded BFS
for name, p in (("er", 4), ("ring", 8), ("rmat8", 2)):
    g = from_edges(*eval(CASES[name]))
    s_sh, d_sh, _, _ = shard_edges(g, p)
    for fd in ("int32", "uint8"):
        fn = shard_map(
            lambda s, d, n=g.n_nodes, fd=fd: bfs_levels(
                s, d, n, root=3, axis_name="p", frontier_dtype=fd)[None],
            mesh=meshes[p], in_specs=(P("p"), P("p")), out_specs=P("p"))
        lev = np.asarray(jax.jit(fn)(
            jnp.asarray(s_sh.reshape(-1)), jnp.asarray(d_sh.reshape(-1))))
        assert (lev == lev[0]).all()  # replicated by the pmax
        out[f"bfs/{name}/{p}/{fd}"] = lev[0]

# the parallel wedge baseline
for name in ("karate", "rmat8"):
    g = from_edges(*eval(CASES[name]))
    for p in (2, 8):
        r = parallel_wedge_triangle_count(g, meshes[p])
        out[f"wedge/{name}/{p}"] = np.array(
            [int(r.triangles), int(r.wedges_routed), int(r.overflow)])
np.savez(sys.argv[1], **out)
"""


def _reference_script() -> str:
    head = (f"PS = {PS!r}\nMODES = {MODES!r}\nCASES = {CASES!r}\n"
            f"PV_RUNS = {PV_RUNS!r}\nSPLIT_LEN = {SPLIT_LEN}\n"
            f"SPLIT_CAPS = {SPLIT_CAPS!r}\n"
            f"PHASES = {tcm.WIRE_PHASES!r}\n")
    return head + textwrap.dedent(_REF_SCRIPT)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference result of this file, from ONE subprocess with
    eight host devices."""
    path = tmp_path_factory.mktemp("ref_distributed") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _reference_script(), str(path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _port_run(name, p, mode, per_vertex, kw):
    eng = tapi.TriangleEngine(device=CPU, mesh=LocalShards(p, CPU))
    g = tcsr.from_edges(*GRAPHS[name], device=CPU)
    return eng.count_distributed_raw(g, options=tapi.TCOptions(
        mode=mode, per_vertex=per_vertex, **dict(kw)))


def _port(name, p, mode, per_vertex=False, **kw):
    """The port's raw result on ``LocalShards(p, "cpu")``, once per
    distinct call in this module (several tests read the same run)."""
    return _port_run(name, p, mode, per_vertex, tuple(sorted(kw.items())))


def _fields(r) -> dict:
    return dict(
        ints=np.array([int(r.triangles), int(r.num_horizontal),
                       int(r.transpose_overflow), int(r.hedge_overflow),
                       int(r.comm.bfs_sweeps)], np.int64),
        k=np.asarray(r.k.numpy(), np.float32),
        per_device=r.per_device.numpy(), recv_counts=r.recv_counts.numpy(),
        comm=np.array([r.comm.phase_bytes()[ph] for ph in tcm.WIRE_PHASES],
                      np.int64),
    )


# ------------------------------------------------------- bit for bit
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_count_distributed_raw_equals_reference(ref, name, p, mode):
    r = _port(name, p, mode)
    key = f"{name}/{p}/{mode}/0"
    for field, got in _fields(r).items():
        want = ref[f"{key}/{field}"]
        assert got.dtype == want.dtype or field == "ints", field
        np.testing.assert_array_equal(got, want, err_msg=f"{key} {field}")
    assert int(r.triangles) == oracle.total_triangles(*GRAPHS[name])
    assert int(r.per_device.sum()) == int(r.triangles)


@pytest.mark.parametrize("name,p,mode", PV_RUNS)
def test_per_vertex_credit_equals_reference(ref, name, p, mode):
    r = _port(name, p, mode, per_vertex=True)
    key = f"{name}/{p}/{mode}/1"
    for field, got in _fields(r).items():
        np.testing.assert_array_equal(got, ref[f"{key}/{field}"],
                                      err_msg=f"{key} {field}")
    pv = r.per_vertex.numpy()
    np.testing.assert_array_equal(pv, ref[f"{key}/per_vertex"])
    np.testing.assert_array_equal(pv, oracle.triangle_counts(*GRAPHS[name]))
    assert int(pv.sum()) == 3 * int(r.triangles)
    if p == 8:
        assert r.comm.phase_bytes()["reduce"] == PINNED_PV_REDUCE


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(PINNED))
def test_pinned_values_at_p8(name, mode):
    r = _port(name, 8, mode)
    pin = PINNED[name]
    assert int(r.triangles) == pin["triangles"]
    assert r.per_device.tolist() == pin["per_device"]
    assert r.recv_counts.tolist() == pin["recv_counts"]
    assert r.comm.phase_bytes() == pin["comm"]


@pytest.mark.parametrize("mode", MODES)
def test_report_and_route(mode):
    eng = tapi.TriangleEngine(device=CPU, mesh=LocalShards(4, CPU))
    rep = eng.count(GRAPHS["karate"], route="distributed",
                    options=tapi.TCOptions(mode=mode, per_vertex=True))
    loc = eng.count(GRAPHS["karate"], route="local",
                    options=tapi.TCOptions(per_vertex=True))
    assert (rep.triangles, rep.c1, rep.c2, rep.levels) == (45, None, None,
                                                           None)
    assert rep.plan_id == f"hedge/{mode}/p4" and rep.options.mode == mode
    assert rep.route == "distributed" and rep.backend == "torch"
    assert rep.num_horizontal == loc.num_horizontal
    assert rep.k == pytest.approx(loc.k, abs=0)
    assert not rep.overflow and rep.per_device.shape == (4,)
    np.testing.assert_array_equal(rep.per_vertex, loc.per_vertex)
    np.testing.assert_array_equal(rep.degrees, loc.degrees)
    assert rep.comm.phase_bytes()["splitter"] == 192
    # "auto" resolves before the report: the provenance names the mode
    auto = eng.count(GRAPHS["karate"], route="distributed")
    assert auto.options.mode == "allgather" and auto.plan_id.startswith(
        "hedge/allgather")
    tiny = tapi.TCOptions(gather_buffer_limit_bytes=8)
    assert eng.count(GRAPHS["karate"], route="distributed",
                     options=tiny).plan_id == "hedge/ring/p4"
    # the reference's report of the same request
    jrep = japi.TriangleEngine().count(GRAPHS["karate"], route="distributed")
    assert (jrep.c1, jrep.c2, jrep.triangles) == (None, None, 45)
    # n = 0 answers at the facade, with the route's contract
    empty = eng.count((np.zeros((0, 2), np.int64), 0), route="distributed",
                      options=tapi.TCOptions(per_vertex=True))
    assert (empty.c1, empty.c2, empty.levels, empty.triangles) == (
        None, None, None, 0)
    assert empty.per_vertex.shape == (0,)


def test_engine_default_mesh_and_checks():
    eng = tapi.TriangleEngine(device=CPU)
    assert (eng.mesh.p, eng.mesh.device.type) == (1, "cpu")
    r = eng.count(gen.rmat(7, 8, seed=2), route="distributed")
    assert r.plan_id.endswith("/p1") and r.comm.total == 0
    with pytest.raises(TypeError, match="shard group"):
        tapi.TriangleEngine(device=CPU, mesh=object())
    pairs = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        tptc.ShardView.from_pairs(pairs, pairs, n=2**30)
    assert tptc.ShardView.from_pairs(pairs, pairs, n=5).adj.n_nodes == 14
    with pytest.raises(ValueError, match="hplan covers"):
        g = tcsr.from_edges(*GRAPHS["karate"], device=CPU)
        m2 = int(g.n_edges_dir)
        ring = tptc.plan_hedge_rounds(g, 4, mode="ring")
        tptc.build_tc_shard_fn(n=g.n_nodes, m2=m2, p=4, mode="allgather",
                               hplan=ring)


@pytest.mark.parametrize("kw", [
    dict(mode="bogus"), dict(frontier_dtype="int64"), dict(slack=0.0),
    dict(slack=-1.0), dict(d_pad=0), dict(hedge_chunk=-3),
    dict(gather_buffer_limit_bytes=0), dict(distributed_timeout_s=0.0),
    dict(distributed_timeout_s=-2.0)])
def test_distributed_option_validation_matches_reference(kw):
    with pytest.raises(ValueError) as je:
        japi.TCOptions(**kw)
    with pytest.raises(ValueError) as te:
        tapi.TCOptions(**kw)
    assert str(te.value) == str(je.value)


def test_distributed_option_defaults_match_reference():
    names = ("mode", "slack", "d_pad", "hedge_chunk", "frontier_dtype",
             "gather_buffer_limit_bytes", "distributed_timeout_s")
    jo, to = japi.TCOptions(), tapi.TCOptions()
    assert [getattr(to, n) for n in names] == [getattr(jo, n) for n in names]
    # the distributed knobs are plan-irrelevant for the batch route
    assert tapi.TCOptions(mode="ring", slack=2.0).plan_view(CPU) \
        == tapi.TCOptions().plan_view(CPU)


@pytest.mark.parametrize("frontier_dtype", ["int32", "uint8"])
def test_frontier_dtype_changes_the_tally_not_the_count(frontier_dtype):
    r = _port("rmat8", 4, "allgather", frontier_dtype=frontier_dtype)
    base = _port("rmat8", 4, "allgather")
    assert int(r.triangles) == int(base.triangles) == 3872
    ratio = 4 if frontier_dtype == "uint8" else 1
    assert r.comm.bfs_per_sweep * ratio == base.comm.bfs_per_sweep
    assert r.comm.bfs_sweeps == base.comm.bfs_sweeps


# ------------------------------------------------------ unit parity
@pytest.mark.parametrize("p", [1, 2, 3, 8])
@pytest.mark.parametrize("name", ["karate", "er", "rmat8"])
def test_shard_edges_equal_reference(name, p):
    jg = jcsr.from_edges(*GRAPHS[name])
    tg = tcsr.from_edges(*GRAPHS[name], device=CPU)
    for cap in (None, 4 * int(jg.n_edges_dir) // p):
        want = jpart.shard_edges(jg, p, capacity=cap)
        got = tpart.shard_edges(tg, p, capacity=cap)
        for w, t in zip(want, got):
            t = t.numpy() if torch.is_tensor(t) else t
            np.testing.assert_array_equal(t, np.asarray(w))
            assert t.dtype == np.asarray(w).dtype
    np.testing.assert_array_equal(
        tpart.vertex_partition(tg.row_offsets.numpy(), p),
        jpart.vertex_partition(np.asarray(jg.row_offsets), p))
    with pytest.raises(ValueError, match="capacity"):
        tpart.shard_edges(tg, p, capacity=1)


@pytest.mark.parametrize("cap", SPLIT_CAPS)
def test_repartition_by_value_equals_reference(ref, cap):
    p = 8
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 500, size=(p, SPLIT_LEN)).astype(np.int32)
    carry = rng.integers(0, 500, size=(p, SPLIT_LEN)).astype(np.int32)
    valid = rng.random((p, SPLIT_LEN)) < 0.7
    vals[~valid] = 501
    rep = tsamp.repartition_by_value(
        torch.from_numpy(vals), torch.from_numpy(carry),
        torch.from_numpy(valid), p, cap, LocalShards(p, CPU), inf=501)
    key = f"split/{cap}"
    np.testing.assert_array_equal(rep.values.numpy(), ref[f"{key}/values"])
    np.testing.assert_array_equal(rep.carry.numpy(), ref[f"{key}/carry"])
    np.testing.assert_array_equal(rep.count.numpy(), ref[f"{key}/count"])
    np.testing.assert_array_equal(rep.splitters.numpy(),
                                  ref[f"{key}/splitters"])
    assert bool(rep.overflow) == bool(ref[f"{key}/overflow"][0])
    assert bool(rep.overflow) == (cap == 9)  # the small cap drops pairs


@pytest.mark.parametrize("fd", ["int32", "uint8"])
@pytest.mark.parametrize("name,p", [("er", 4), ("ring", 8), ("rmat8", 2)])
def test_sharded_bfs_levels_equal_reference(ref, name, p, fd):
    g = tcsr.from_edges(*GRAPHS[name], device=CPU)
    s_sh, d_sh, _, _ = tpart.shard_edges(g, p)
    shards = LocalShards(p, CPU)
    with shards.recording() as record:
        lev = tbfs.bfs_levels_sharded(s_sh, d_sh, g.n_nodes, root=3,
                                      shards=shards, frontier_dtype=fd)
    np.testing.assert_array_equal(lev.numpy(), ref[f"bfs/{name}/{p}/{fd}"])
    # the same levels as the local route's CSR sweep
    np.testing.assert_array_equal(
        lev.numpy(), tbfs.bfs_levels(g.src, g.dst, g.n_nodes, 3,
                                     row_offsets=g.row_offsets).numpy())
    # one int32 has-edge pmax, then one frontier pmax a sweep
    assert record[0].kind == "pmax" and not record[0].in_bfs
    sweeps = [c for c in record if c.in_bfs]
    assert all(c.kind == "pmax" and c.dtype == fd for c in sweeps)
    assert len(sweeps) == int(lev[lev != tbfs.UNVISITED].max()) + 1


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", [1, 2, 8])
@pytest.mark.parametrize("name", ["karate", "rmat8", "rmat10"])
def test_plan_hedge_rounds_equals_reference(name, p, mode):
    jg = jcsr.from_edges(*GRAPHS[name])
    tg = tcsr.from_edges(*GRAPHS[name], device=CPU)
    for chunk in (None, 8):
        jp = jptc.plan_hedge_rounds(jg, p, mode=mode, hedge_chunk=chunk)
        tp = tptc.plan_hedge_rounds(tg, p, mode=mode, hedge_chunk=chunk)
        assert [dataclasses.astuple(b) for b in tp.buckets] == [
            dataclasses.astuple(b) for b in jp.buckets]
        assert (tp.total_rows, tp.probe_rows, tp.probe_cells, tp.peak_rows,
                tp.query_chunk, tp.sort_queries) == (
            jp.total_rows, jp.probe_rows, jp.probe_cells, jp.peak_rows,
            jp.query_chunk, jp.sort_queries)
    if name == "rmat10" and p == 2:
        assert len(tp.buckets) > 1  # the degree bucketing did not collapse


@pytest.mark.parametrize("name", ["karate", "er", "rmat8"])
def test_pair_list_adjacency_equals_csr_view(name):
    """A CSR edge list IS a lex-sorted pair list: the same bounds, and
    ``run_plan`` gives the same counts and credit over either view."""
    g = tcsr.from_edges(*GRAPHS[name], device=CPU)
    csr = tint.CsrAdjacency.from_graph(g)
    pl = tint.PairListAdjacency(owners=g.src, values=g.dst,
                                n_nodes=g.n_nodes)
    assert pl.flat is g.dst
    v = torch.arange(g.n_nodes + 3, dtype=torch.int32)
    for a, b in zip(pl.bounds(v), csr.bounds(v)):
        a, b = a.numpy(), b.numpy()
        np.testing.assert_array_equal(a[:g.n_nodes], b[:g.n_nodes])
    assert (pl.bounds(v)[1][g.n_nodes:] == 0).all()
    lev = tbfs.bfs_levels(g.src, g.dst, g.n_nodes, row_offsets=g.row_offsets)
    qu, qw, *_ = tedges.horizontal_queries(g, lev, order="desc")
    plan = tint.plan_buckets_bounded(
        qu.shape[0], d_pad=tcsr.max_degree(g),
        exceed=tuple(zip((4,), tedges.mindeg_exceedance(g, (4,)))),
        bucket_widths=(4,), sort_queries=False)
    assert len(plan.buckets) == 2
    for level in (None, lev):
        for pv in (False, True):
            a = tint.run_plan(pl, qu, qw, plan, level=level, per_vertex=pv)
            b = tint.run_plan(csr, qu, qw, plan, level=level, per_vertex=pv)
            for x, y in zip(a, b):
                if x is not None:
                    np.testing.assert_array_equal(x.numpy(), y.numpy())
    # the reference's pair-list view, on the same arrays
    jg = jcsr.from_edges(*GRAPHS[name])
    jpl = jint.PairListAdjacency(owners=jg.src, values=jg.dst,
                                 n_nodes=jg.n_nodes)
    for a, b in zip(pl.bounds(v), jpl.bounds(jnp.asarray(v.numpy()))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("per_vertex", [False, True])
@pytest.mark.parametrize("name", ["karate", "rmat8"])
def test_run_plan_sort_queries_equals_reference(name, per_vertex):
    """A bounded plan with the in-run sort over an unsorted block (the
    graph's undirected edges in CSR order): counts, overflow and credit
    equal to the reference's ``run_plan``, and the same under any slice
    size."""
    jg = jcsr.from_edges(*GRAPHS[name])
    tg = tcsr.from_edges(*GRAPHS[name], device=CPU)
    eu, ew, und = tcsr.undirected_edges(tg)
    n = tg.n_nodes
    qu = torch.where(und, eu, n + 1)
    qw = torch.where(und, ew, n + 1)
    exceed = tedges.mindeg_exceedance(tg, (4, 16))
    for d_pad in (tcsr.max_degree(tg), 8):
        kw = dict(d_pad=d_pad, exceed=tuple(zip((4, 16), exceed)),
                  bucket_widths=(4, 16), row_mult=32, query_chunk=32)
        tp = tint.plan_buckets_bounded(qu.shape[0], **kw)
        jp = jint.plan_buckets_bounded(qu.shape[0], backend="jnp", **kw)
        assert tp.sort_queries and jp.sort_queries and len(tp.buckets) > 1
        want = jint.run_plan(
            jint.CsrAdjacency.from_graph(jg), jnp.asarray(qu.numpy()),
            jnp.asarray(qw.numpy()), jp, per_vertex=per_vertex)
        # the plan's own slices, short slices with a short last one, and
        # each bucket whole: the same integers
        for chunk in (tp.query_chunk, 5, 10**6):
            got = tint.run_plan(tint.CsrAdjacency.from_graph(tg), qu, qw,
                                dataclasses.replace(tp, query_chunk=chunk),
                                level=None, per_vertex=per_vertex)
            assert int(got.c1) == int(want.c1)
            assert bool(got.overflow) == bool(want.overflow)
            if per_vertex:
                np.testing.assert_array_equal(got.per_vertex.numpy(),
                                              np.asarray(want.per_vertex))


# ----------------------------------------------------------- comm report
@pytest.mark.parametrize("per_vertex", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_comm_report_measured_equals_tally_and_model(p, mode, per_vertex):
    g = tcsr.from_edges(*GRAPHS["rmat8"], device=CPU)
    r = _port("rmat8", p, mode, per_vertex=per_vertex)
    rep = tci.comm_report(g.n_nodes, int(g.n_edges_dir), p,
                          sweeps=r.comm.bfs_sweeps, calls=r.collectives,
                          mode=mode, per_vertex=per_vertex)
    for ph, row in rep["phases"].items():
        assert row["measured"] == row["tally"] == row["modeled"], (ph, row)
        if p == 1:
            assert row["measured"] == 0
    assert rep["measured_total"] == r.comm.total
    # the record: one has-edge pmax, a pmax a sweep, one splitter gather,
    # two all-to-alls, the hedge exchange, six scalar reductions (+1)
    kinds = [c.kind for c in r.collectives]
    assert kinds.count("all_to_all") == 2
    sweeps = sum(c.in_bfs for c in r.collectives)
    assert sweeps == r.comm.bfs_sweeps
    scalar = [c for c in r.collectives
              if c.kind in ("psum", "pmax") and c.shape == ()]
    assert len(scalar) == tcm.NUM_SCALAR_REDUCES
    if mode == "ring":
        assert kinds.count("ppermute") == 2 * (p - 1)
        assert "all_gather" in kinds[:kinds.index("all_to_all")]
    else:
        assert kinds.count("all_gather") == 3 and "ppermute" not in kinds


@pytest.mark.parametrize("p", [2, 4, 8])
def test_hedge_bytes_equal_across_modes_and_buffer_ratio(p):
    a = _port("rmat10", p, "allgather").comm.phase_bytes()
    b = _port("rmat10", p, "ring").comm.phase_bytes()
    assert a == b
    m2 = int(tcsr.from_edges(*GRAPHS["rmat10"], device=CPU).n_edges_dir)
    assert tci.hedge_round_buffer_bytes(m2, p, "allgather") == \
        p * tci.hedge_round_buffer_bytes(m2, p, "ring")
    from repro.core import comm_instrument as jci

    for mode in MODES:
        assert tci.hedge_round_buffer_bytes(m2, p, mode) == \
            jci.hedge_round_buffer_bytes(m2, p, mode)
    for limit in (1 << 10, 1 << 20, 64 << 20):
        assert tci.choose_hedge_mode(
            m2, p, gather_buffer_limit_bytes=limit) == jci.choose_hedge_mode(
            m2, p, gather_buffer_limit_bytes=limit)


def test_tally_and_model_copy_the_reference():
    from repro.core import comm_instrument as jci
    from repro.core import comm_model as jcm

    rng = np.random.default_rng(0)
    for _ in range(20):
        kw = dict(n=int(rng.integers(2, 5000)), p=int(rng.integers(1, 17)),
                  cap_chunk=int(rng.integers(4, 4096)),
                  cap_hedge=int(rng.integers(1, 8192)),
                  sweeps=int(rng.integers(1, 40)))
        for mode in MODES:
            for fd in ("int32", "uint8"):
                for pv in (False, True):
                    assert tci.tally_comm(
                        mode=mode, frontier_dtype=fd, per_vertex=pv, **kw
                    ).phase_bytes() == jci.tally_comm(
                        mode=mode, frontier_dtype=fd, per_vertex=pv, **kw
                    ).phase_bytes()
    assert tci.tally_comm(n=2**40, p=64, cap_chunk=2**30, cap_hedge=2**30,
                          mode="ring", frontier_dtype="int32",
                          sweeps=3).hedge == tci.TALLY_SAT_BYTES
    for name, row in jcm.TABLE_I.items():
        n, m, _, wedges, k, p = row[:6]
        assert dataclasses.astuple(tcm.cover_edge_comm(n, m, k, p)) == \
            dataclasses.astuple(jcm.cover_edge_comm(n, m, k, p)), name
        assert tcm.speedup(n, m, k, p, wedges) == jcm.speedup(
            n, m, k, p, wedges)
    assert tcm.NUM_SCALAR_REDUCES == jcm.NUM_SCALAR_REDUCES
    assert tcm.WIRE_PHASES == jcm.WIRE_PHASES


def test_per_call_mesh_on_another_device_type_raises():
    # a shard group passed per call gets the engine's device check too:
    # a group on another device type would move the route's work there
    eng = tapi.TriangleEngine(device=CPU)
    with pytest.raises(ValueError, match="shard group lives on"):
        eng.count_distributed_raw(gen.karate(), mesh=LocalShards(2, "meta"))
    with pytest.raises(ValueError, match="shard group lives on"):
        tapi.TriangleEngine(device=CPU, mesh=LocalShards(2, "meta"))
    r = eng.count_distributed_raw(gen.karate(), mesh=LocalShards(2, CPU))
    assert int(r.triangles) == 45 and r.per_device.shape == (2,)


# --------------------------------------------------------- wedge baseline
@pytest.mark.parametrize("p", [2, 8])
@pytest.mark.parametrize("name", ["karate", "rmat8"])
def test_parallel_wedge_baseline_equals_reference(ref, name, p):
    g = tcsr.from_edges(*GRAPHS[name], device=CPU)
    r = twedge.parallel_wedge_triangle_count(g, LocalShards(p, CPU))
    got = [int(r.triangles), int(r.wedges_routed), int(r.overflow)]
    assert got == ref[f"wedge/{name}/{p}"].tolist()
    assert got[0] == oracle.total_triangles(*GRAPHS[name])
    kinds = [c.kind for c in r.collectives]
    assert kinds.count("all_to_all") == 2 and "all_gather" not in kinds
    wire = tci.measured_phase_bytes(r.collectives, n=g.n_nodes, p=p)
    assert wire["transpose"] > 0


# ----------------------------------------------------------- gloo ranks
_RANK_SCRIPT = r"""
import json, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=world)
from repro_torch.api import TCOptions, TriangleEngine
from repro_torch.core.shards import GroupShards
from repro_torch.graph import generators as gen
out = []
mesh = GroupShards()
assert mesh.device.type == "cpu"  # gloo carries host tensors
eng = TriangleEngine(device="cpu", mesh=mesh)
for expr in ("gen.karate()", "gen.rmat(8, 8, seed=1)"):
    for mode in ("allgather", "ring"):
        for pv in (False, True):
            r = eng.count_distributed_raw(
                eval(expr), options=TCOptions(mode=mode, per_vertex=pv))
            out.append(dict(
                tri=int(r.triangles), k=float(r.k),
                nh=int(r.num_horizontal),
                ovf=[bool(r.transpose_overflow), bool(r.hedge_overflow)],
                per_device=r.per_device.tolist(),
                recv=r.recv_counts.tolist(), comm=r.comm.phase_bytes(),
                pv=None if r.per_vertex is None else r.per_vertex.tolist(),
                calls=[[c.kind, list(c.shape), c.dtype, c.nbytes, c.in_bfs,
                        c.cross] for c in r.collectives]))
dist.destroy_process_group()
print(json.dumps(out))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [2, 4])
def test_group_shards_over_gloo_equal_local_shards(world):
    init = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_SCRIPT, str(r), str(world), init],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = []
    try:
        for pr in procs:
            so, se = pr.communicate(timeout=120)
            assert pr.returncode == 0, se[-3000:]
            outs.append(json.loads(so.strip().splitlines()[-1]))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    assert all(o == outs[0] for o in outs[1:])  # every rank agrees
    i = 0
    for name in ("karate", "rmat8"):
        for mode in MODES:
            for pv in (False, True):
                r = _port(name, world, mode, per_vertex=pv)
                want = dict(
                    tri=int(r.triangles), k=float(r.k),
                    nh=int(r.num_horizontal),
                    ovf=[bool(r.transpose_overflow),
                         bool(r.hedge_overflow)],
                    per_device=r.per_device.tolist(),
                    recv=r.recv_counts.tolist(), comm=r.comm.phase_bytes(),
                    pv=None if r.per_vertex is None
                    else r.per_vertex.tolist(),
                    calls=[[c.kind, list(c.shape), c.dtype, c.nbytes,
                            c.in_bfs, c.cross] for c in r.collectives])
                assert outs[0][i] == want, (name, mode, pv)
                i += 1


def test_local_shards_collectives():
    sh = LocalShards(3, CPU)
    x = torch.arange(3 * 3 * 2, dtype=torch.int32).view(3, 3, 2)
    with sh.recording() as rec:
        a2a = sh.all_to_all(x)
        assert torch.equal(a2a, x.transpose(0, 1))
        y = torch.tensor([[1, 5], [4, 2], [3, 3]], dtype=torch.int32)
        assert sh.psum(y).tolist() == [8, 10]
        assert sh.pmax(y).tolist() == [4, 5]
        assert torch.equal(sh.all_gather(y), y)
        perm = sh.ppermute(y, [(0, 1), (1, 2), (2, 0)])
        assert perm.tolist() == [[3, 3], [1, 5], [4, 2]]
        assert sh.ppermute(y, [(0, 1)]).tolist() == [[0, 0], [1, 5], [0, 0]]
    assert [c.kind for c in rec] == ["all_to_all", "psum", "pmax",
                                     "all_gather", "ppermute", "ppermute"]
    assert rec[0].nbytes == 3 * 2 * 4 and rec[4].cross == 3
    assert rec[5].cross == 1
    with pytest.raises(ValueError, match="leading axis"):
        sh.psum(torch.zeros(2, 4))
    with pytest.raises(ValueError, match="positive"):
        LocalShards(0, CPU)


# ----------------------------------------------------------------- serving
def _capped(mesh_p=4, **kw):
    return tapi.TriangleEngine(
        tapi.TCOptions(**kw),
        budgets=tcsr.BudgetGrid(max_nodes=256, max_slots=2048), device=CPU,
        mesh=LocalShards(mesh_p, CPU))


class _StallFirstAttempt(trobust.FaultPlan):
    """Stalls only the first attempt of each selected request, so the
    ring retry runs while the abandoned attempt is still running."""

    def before_distributed(self, rid, attempt):
        if attempt == 0:
            super().before_distributed(rid, attempt)


def test_server_answers_over_budget_requests_on_the_distributed_route():
    big = gen.rmat(9, 8, seed=0)
    want = oracle.total_triangles(*big)
    srv = _capped().serve(batch_size=4)
    ids = [srv.submit(*big), srv.submit(*gen.karate()),
           srv.submit(*gen.rmat(9, 8, seed=3))]
    res = {r.request_id: r for r in srv.drain()}
    assert res[ids[0]].route == "distributed"
    assert res[ids[0]].triangles == want and res[ids[0]].c1 is None
    assert res[ids[0]].report.plan_id.startswith("hedge/")
    assert res[ids[0]].budget.n_budget == big[1]
    assert res[ids[1]].route == "batched" and res[ids[1]].triangles == 45
    assert res[ids[2]].triangles == oracle.total_triangles(
        *gen.rmat(9, 8, seed=3))
    s = srv.summary()
    assert (s["distributed_requests"], s["distributed_timeouts"],
            s["distributed_retries"], s["abandoned_distributed"]) == (
        2, 0, 0, 0)
    # the engine's "auto" route past the capped grid's top cell
    rep = _capped().count(big)
    assert (rep.route, rep.triangles) == ("distributed", want)


def test_stalled_attempt_times_out_and_the_retry_is_exact():
    big = gen.rmat(9, 8, seed=0)
    # the abandoned attempt wakes 0.3 s into the retry and runs beside it
    srv = _capped(distributed_timeout_s=3.0).serve(
        faults=_StallFirstAttempt(stall_distributed_every=1,
                                  distributed_stall_s=3.3))
    rid = srv.submit(*big)
    (r,) = srv.drain()
    assert (r.request_id, r.route) == (rid, "distributed")
    assert r.triangles == oracle.total_triangles(*big)
    assert r.report.options.mode == "ring" and not r.overflow
    s = srv.summary()
    assert (s["distributed_requests"], s["distributed_timeouts"],
            s["distributed_retries"], s["abandoned_distributed"]) == (
        1, 1, 1, 1)


@pytest.mark.parametrize("attempts", [1, 2])
def test_fail_distributed_degrades_as_the_reference(attempts):
    """``fail_distributed_every=1``: with one failing attempt the ring
    retry answers exactly; with two the request degrades to the approx
    lane (``seed=request id``), on both servers, counters equal."""
    from repro.launch import robust as jrobust

    big = gen.rmat(9, 8, seed=0)
    plan = dict(fail_distributed_every=1, fail_distributed_attempts=attempts)
    out = []
    for srv in (
        _capped().serve(faults=trobust.FaultPlan(**plan)),
        japi.TriangleEngine(budgets=jcsr.BudgetGrid(
            max_nodes=256, max_slots=2048)).serve(
            faults=jrobust.FaultPlan(**plan)),
    ):
        srv.submit(*gen.karate())
        srv.submit(*big)
        res = sorted(srv.drain(), key=lambda r: r.request_id)
        s = srv.summary()
        out.append(([(r.request_id, r.route, r.triangles) for r in res],
                    [s[k] for k in ("distributed_requests",
                                    "distributed_timeouts",
                                    "distributed_retries",
                                    "abandoned_distributed",
                                    "approx_answers")]))
    assert out[0] == out[1]
    routes = [r for _, r, _ in out[0][0]]
    assert routes == ["batched", "distributed" if attempts == 1
                      else "approx"]


def test_server_counters_equal_reference_on_one_trace():
    from repro.launch import robust as jrobust

    reqs = [gen.rmat(9, 8, seed=s) for s in range(3)] + [gen.karate()]
    plan = dict(fail_distributed_every=2, fail_distributed_attempts=1)
    got = []
    for srv in (
        _capped().serve(batch_size=2, faults=trobust.FaultPlan(**plan)),
        japi.TriangleEngine(budgets=jcsr.BudgetGrid(
            max_nodes=256, max_slots=2048)).serve(
            batch_size=2, faults=jrobust.FaultPlan(**plan)),
    ):
        for e, n in reqs:
            srv.submit(e, n)
        res = sorted(srv.drain(), key=lambda r: r.request_id)
        s = srv.summary()
        got.append(([(r.request_id, r.route, r.triangles) for r in res],
                    {k: s[k] for k in ("distributed_requests",
                                       "distributed_timeouts",
                                       "distributed_retries",
                                       "abandoned_distributed")}))
    assert got[0] == got[1]
    assert got[0][1]["distributed_retries"] == 1
