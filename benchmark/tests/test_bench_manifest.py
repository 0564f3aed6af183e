"""BENCHMARK.json against the contract's naming rules, and every file a
cell needs found by name."""

import json
import os

from benchmark.harness import manifest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MAN = manifest.load(REPO)

TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_keys_names_and_units():
    assert set(MAN) == TOP
    for section, allowed in KEYS.items():
        for entry in MAN[section]:
            assert set(entry) <= allowed, (section, entry)
    assert manifest.problems(REPO, MAN) == []
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    for text in [c["why"] for c in MAN["configs"] + MAN["workloads"]] + \
            [c["source"] for c in MAN["configs"]] + [m["layer"] for m in MAN["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds_and_budget():
    assert 1 <= MAN["run_seconds"] <= 51
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_cell_finds_its_files_and_reports_enough():
    names = {c["name"] for c in MAN["configs"]}
    for w in MAN["workloads"]:
        assert w["config"] in names and w["chips"] in (1, 4)
        spec = manifest.traffic(REPO, w["traffic"])
        kind = manifest.kind(REPO, spec)
        config = manifest.config(REPO, MAN, w["config"])
        assert os.path.exists(os.path.join(REPO, config["urdf"]))
        e2e = [m["name"] for m in manifest.end_to_end(MAN, w["name"], kind)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert all(n == "setup_s" or n in kind.E2E for n in e2e)
        layer = manifest.per_layer(MAN, w["name"], kind)
        assert layer and all(m["moves"] in e2e for m in layer)
        for m in layer:
            assert callable(manifest.reader(REPO, m["name"]).read)
        assert set(spec["limits"]) <= {"gram_rel_err", "base_rows_rel_err", "resid_report_gap_pct",
                                       "resid_gap_pct", "inconsistency"}
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(MAN["workloads"]) // 4)


def test_config_files_state_their_cut():
    for c in MAN["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and "assumed" in cfg
