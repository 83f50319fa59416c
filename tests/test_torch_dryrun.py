"""The port's dry run (``repro_torch.configs.registry.build_cell``,
``repro_torch.launch.dryrun``) held against the reference's
``repro.configs.registry.build_cell`` on both production layouts.

One subprocess with 512 forced host devices builds every reference cell
on ``make_production_mesh()`` and on the multi-pod mesh (the 40
``all_cells()`` and ``cover-edge-tc``'s ``rmat_smoke`` and ``rmat_pod``)
without compiling anything, and records each cell's kind, skip reason,
``model_flops``, parameter count and per-device argument bytes,
``sum(prod(sharding.shard_shape(a.shape)) * itemsize)`` over the cell's
arguments.  The port builds the same cells on the ``meta`` device.  They
agree on the kind, the skip set and reason, ``model_flops`` to a
relative 1e-12, the parameter count, and the bytes as integers, but for
one named difference: the port keeps two scalars on the host that the
reference passes as int32 device arguments, AdamW's step count (every
``train`` cell) and the decode position (every ``decode`` cell), so
those cells hold HOST_SCALAR_BYTES fewer bytes a card (ROADMAP,
deliberate differences).  ``--list`` and ``opt_overrides`` equal the
reference's, and the CLI runs end to end into ``tmp_path``."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import registry as treg
from repro_torch.launch import dryrun as tdry
from repro_torch.launch.mesh import make_production_mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TC_CELLS = [("cover-edge-tc", "rmat_smoke"), ("cover-edge-tc", "rmat_pod")]
CELLS = treg.all_cells() + TC_CELLS
MESHES = ("pod", "multipod")
#: bytes a card of the reference's int32 scalar arguments that the port
#: keeps on the host, by cell kind
HOST_SCALAR_BYTES = {"train": 4, "decode": 4}
FLOPS_RTOL = 1e-12

_REF = r"""
import contextlib, io, json, math, os, sys, time
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, numpy as np
from repro.configs.registry import (ASSIGNED_ARCHS, all_cells, build_cell,
                                    opt_overrides)
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh
out = {"opt": {a: opt_overrides(a) for a in ASSIGNED_ARCHS
               + ["cover-edge-tc"]}, "list": {}}
for flags in (["--list"], ["--list", "--include-tc"],
              ["--list", "--arch", "bst"], ["--list", "--shape", "long_500k"]):
    buf = io.StringIO()
    sys.argv = ["dryrun"] + flags
    with contextlib.redirect_stdout(buf):
        dryrun.main()
    out["list"][" ".join(flags)] = buf.getvalue()
cells = all_cells() + [("cover-edge-tc", "rmat_smoke"),
                       ("cover-edge-tc", "rmat_pod")]
for name, multi in (("pod", False), ("multipod", True)):
    mesh = make_production_mesh(multi_pod=multi)
    t0 = time.time()
    recs = {}
    for a, s in cells:
        c = build_cell(a, s, mesh)
        rec = {"kind": c.kind, "skip": c.skip_reason,
               "flops": c.model_flops}
        if not c.skipped:
            leaves = jax.tree.leaves(c.args)
            shards = jax.tree.leaves(c.in_shardings)
            assert len(leaves) == len(shards), (a, s)
            rec["bytes"] = int(sum(
                math.prod(sh.shard_shape(x.shape))
                * np.dtype(x.dtype).itemsize
                for x, sh in zip(leaves, shards)))
            if c.kind != "tc":
                rec["params"] = int(sum(math.prod(x.shape) for x in
                                        jax.tree.leaves(c.args[0])))
        recs[f"{a}|{s}"] = rec
    out[name] = {"shape": dict(mesh.shape), "cells": recs,
                 "seconds": time.time() - t0}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REF], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cell_list_equals_reference(ref):
    for mesh in MESHES:
        assert sorted(ref[mesh]["cells"]) == sorted(
            f"{a}|{s}" for a, s in CELLS)
    assert len(treg.all_cells()) == 40


def test_layouts_equal_reference_meshes(ref):
    for mesh in MESHES:
        lay = make_production_mesh(multi_pod=mesh == "multipod")
        assert lay.shape == ref[mesh]["shape"]
        assert list(lay.shape) == list(ref[mesh]["shape"])  # axis order


@pytest.mark.parametrize("arch,shape", CELLS)
@pytest.mark.parametrize("mesh", MESHES)
def test_cell_equals_reference(ref, mesh, arch, shape):
    want = ref[mesh]["cells"][f"{arch}|{shape}"]
    layout = make_production_mesh(multi_pod=mesh == "multipod")
    cell = treg.build_cell(arch, shape, layout)
    assert cell.kind == want["kind"]
    assert cell.skip_reason == want["skip"]
    if cell.skipped:
        return
    assert abs(cell.model_flops - want["flops"]) <= FLOPS_RTOL * abs(
        want["flops"])
    got = cell.argument_bytes(layout)
    assert got + HOST_SCALAR_BYTES.get(cell.kind, 0) == want["bytes"]
    if "params" in want:
        assert cell.param_count == want["params"]


def test_skips_equal_reference(ref):
    for mesh in MESHES:
        skipped = {k for k, v in ref[mesh]["cells"].items() if v["skip"]}
        assert skipped == {"smollm-135m|long_500k",
                           "qwen2-moe-a2.7b|long_500k",
                           "phi3.5-moe-42b-a6.6b|long_500k"}


def test_opt_overrides_equal_reference(ref):
    for arch, want in ref["opt"].items():
        assert treg.opt_overrides(arch) == want, arch


@pytest.mark.parametrize("flags", [["--list"], ["--list", "--include-tc"],
                                   ["--list", "--arch", "bst"],
                                   ["--list", "--shape", "long_500k"]])
def test_list_equals_reference(ref, capsys, flags):
    assert tdry.main(flags) == 0
    assert capsys.readouterr().out == ref["list"][" ".join(flags)]


def test_cli_end_to_end(tmp_path, capsys):
    out = tmp_path / "dry.json"
    assert tdry.main(["--mesh", "multipod", "--arch", "qwen2-moe-a2.7b",
                      "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert sorted(res) == sorted(f"qwen2-moe-a2.7b|{s}" for s in (
        "train_4k", "prefill_32k", "decode_32k", "long_500k"))
    rec = res["qwen2-moe-a2.7b|train_4k"]
    assert rec["status"] == "ok" and rec["kind"] == "train"
    assert rec["argument_bytes"] == 11_396_472_832
    assert rec["param_count"] == 15_146_256_384
    assert res["qwen2-moe-a2.7b|long_500k"]["status"] == "skipped"
    # a variant merges into the same file under its tag
    assert tdry.main(["--mesh", "multipod", "--include-tc", "--shape",
                      "rmat_pod", "--opt", "--tag", "v", "--set",
                      "slack=2.0,d_pad=64", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    rec = res["cover-edge-tc|rmat_pod|v"]
    assert rec["status"] == "ok" and rec["argument_bytes"] == 4_194_304
    assert rec["overrides"] == {"slack": 2.0, "d_pad": 64}
    assert "qwen2-moe-a2.7b|train_4k" in res
    assert "9/9 cells OK" not in capsys.readouterr().out


def test_cli_records_an_error_and_exits_1(tmp_path):
    """The MoE smoke configs' 8 and 4 expert slots do not divide over the
    16-way model axis: an ``error`` record, exit 1."""
    out = tmp_path / "dry.json"
    assert tdry.main(["--arch", "phi3.5-moe-42b-a6.6b", "--shape",
                      "train_4k", "--smoke", "--out", str(out)]) == 1
    rec = json.loads(out.read_text())["phi3.5-moe-42b-a6.6b|train_4k"]
    assert rec["status"] == "error" and "does not divide" in rec["error"]


def test_parse_overrides():
    assert tdry.parse_overrides(None) is None
    assert tdry.parse_overrides(
        "a=1,b=2.5,c=true,d=False,moe.dispatch=a2a") == {
        "a": 1, "b": 2.5, "c": True, "d": False, "moe.dispatch": "a2a"}


def test_overrides_reach_the_config():
    lay = make_production_mesh()
    base = treg.build_cell("smollm-135m", "decode_32k", lay)
    bf16 = treg.build_cell("smollm-135m", "decode_32k", lay,
                           overrides={"act_dtype": "bfloat16"})
    assert bf16.args[1][0].dtype.itemsize == 2  # the cache in bf16
    assert base.args[1][0].dtype.itemsize == 4
    a2a = treg.build_cell("qwen2-moe-a2.7b", "prefill_32k", lay,
                          overrides=treg.opt_overrides("qwen2-moe-a2.7b"))
    assert a2a.argument_bytes(lay) == treg.build_cell(
        "qwen2-moe-a2.7b", "prefill_32k", lay).argument_bytes(lay)


def test_dry_run_touches_no_device():
    cell = treg.build_cell("gemma3-4b", "train_4k", make_production_mesh())
    params, opt = cell.args[0], cell.args[1]
    assert all(p.device.type == "meta" for p in params.values())
    assert all(m.device.type == "meta" for m in opt["mu"].values())
