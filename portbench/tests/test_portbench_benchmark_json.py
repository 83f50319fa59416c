"""``BENCHMARK.json`` against the benchmark's contract: keys, names and
units of the allowed characters, every file it names present, and
``run_seconds`` within the check's time."""
import _setup  # noqa: F401
import json
import re

import pytest

ROOT = _setup.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits in 43,200 s
    runs = 2 + 14 * 24
    assert (runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)


@pytest.mark.parametrize("section", list(KEYS))
def test_entries_names_and_keys(section):
    entries = BENCH[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end",
                                              "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert text_ok(e[k])


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    assert len(BENCH["workloads"]) <= 24 and len(configs) <= 24
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (ROOT / "portbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
    files = [c["file"] for c in configs.values()]
    assert len(set(files)) == len(files)
    for c in configs.values():
        assert c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        assert set(c["reduced"]) == set(cfg["reduced"])
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg
        assert (ROOT / "portbench" / "generators"
                / f"{cfg['generator']}.py").is_file()


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"count_s", "peak_mem_gb", "setup_s"} <= set(e2e)
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] == "count_s"
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["unit"] == "%":
            assert m["name"].endswith(("_pct", "_roofline_pct"))
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    for c in cells:
        assert sum("workloads" not in m or c in m["workloads"]
                   for m in BENCH["per_layer"]) >= 1
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf
