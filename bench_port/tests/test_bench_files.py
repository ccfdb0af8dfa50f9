"""BENCHMARK.json against its format rules, and every cell, configuration,
driver and per-layer metric found by its name."""

from __future__ import annotations

import json
import os
import re
import shutil

from conftest import ROOT, cpu_run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_sizes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16 and 1 <= len(b["command"]) <= 32
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p
        assert not p.endswith("_torch") and os.path.isdir(
            os.path.join(ROOT, p))
    for word in b["command"]:
        assert not word.startswith("/") and ".." not in word
    assert b["command"][1].startswith(b["paths"][0] + "/")
    n = len(b["workloads"])
    assert 1 <= n <= 24 and 1 <= len(b["configs"]) <= 24
    # a full check of 24 cells fits its 43200 s
    t = b["run_seconds"]
    assert 1 <= t <= 51 and (2 + 14 * 24) * (t + 60) + 24 * 180 + 1200 \
        <= 43200


def test_names_units_and_lines():
    b = bench()
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                        and "\t" not in e[key], (e["name"], key)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not re.search(r"(size|_dim|_rank|heads|experts_per|"
                                 r"factor)", key), key
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(b["workloads"]) // 4)
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}


def test_metrics():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert UNIT.match(m["unit"])
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", cells)
    # every cell reports set-up, another end-to-end and a per-layer metric
    from bench_port import harness
    for w in cells:
        names = {m["name"] for m in harness.cell_metrics(b, w, "end_to_end")}
        assert "setup_s" in names and len(names) >= 2
        assert harness.cell_metrics(b, w, "per_layer")


def test_every_file_found_by_name():
    from bench_port import harness
    b = bench()
    for w in b["workloads"]:
        entry, cell, cfg = harness.cell_files(b, w["name"])
        assert cell["config"] == w["config"] and cfg["name"] == w["config"]
        assert harness.driver(cell["driver"]).run
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        assert c["file"].startswith(b["paths"][0] + "/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for m in b["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_each_reader_reads_nothing_from_an_empty_record():
    from bench_port import harness
    for m in bench()["per_layer"]:
        assert harness.reader(m["name"])({}) is None


def test_alexnet_file_is_the_shipped_conf():
    from singa_tpu_torch import load_model_config
    from singa_tpu_torch.config.schema import (config_to_dict,
                                               model_config_from_dict)
    with open(os.path.join(ROOT, "bench_port/configs/"
                           "alexnet_cifar10.json")) as f:
        mine = model_config_from_dict(json.load(f)["model"])
    shipped = load_model_config(os.path.join(ROOT, "examples/cifar10/"
                                             "alexnet.conf"))
    assert config_to_dict(mine) == config_to_dict(shipped)


def test_a_cell_added_as_files_alone(tmp_path):
    """A new cell is a new cell file and a new entry: the harness finds
    and runs it with no other edit."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "bench_port"), root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    with open(root / "bench_port/cells/mistral7b_l4.train_s4096.json") as f:
        cell = json.load(f)
    cell.update(traffic="train_s2048", batch=8, seq=2048)
    with open(root / "bench_port/cells/mistral7b_l4.train_s2048.json",
              "w") as f:
        json.dump(cell, f)
    b["workloads"].append({"name": "mistral7b_l4.train_s2048",
                           "config": "mistral7b_l4",
                           "traffic": "train_s2048", "chips": 1,
                           "why": "an added cell"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "mistral7b_l4.train_s4096" in m.get("workloads", []):
            m["workloads"].append("mistral7b_l4.train_s2048")
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(b, f)
    rc, line = cpu_run("mistral7b_l4.train_s2048", bench=b, root=str(root))
    assert rc == 0 and line["correct"]
    assert set(line["metrics"]) == {"setup_s", "train_tokens_per_s"}
