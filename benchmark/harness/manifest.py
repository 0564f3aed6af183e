"""BENCHMARK.json and the files it names: each cell's configuration, its
traffic mix and the readers of its per-layer metrics are found by name."""

from __future__ import annotations

import importlib.util
import json
import os
import re

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(root: str, man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(root: str, name: str) -> dict:
    with open(os.path.join(root, "benchmark", "traffic", f"{name}.json")) as f:
        return json.load(f)


def kind(root: str, traffic_spec: dict):
    """benchmark/kinds/<kind>.py, which runs this traffic's kind: its Cell
    (set-up, the timed unit, the spans, the record the per-layer readers
    read, the check) and E2E, the end-to-end metrics it gives, each by the
    name of the Window statistic that is its value."""
    name = traffic_spec["kind"]
    path = os.path.join(root, "benchmark", "kinds", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark.kinds.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end(man: dict, cell: str, kind) -> list:
    """End-to-end metrics reported in `cell`: setup_s and those its kind
    gives, less any whose `workloads` list leaves the cell out."""
    return [m for m in man["end_to_end"]
            if (m["name"] == "setup_s" or m["name"] in kind.E2E)
            and cell in m.get("workloads", [cell])]


def per_layer(man: dict, cell: str, kind) -> list:
    """Per-layer metrics asked of `cell`: those that move an end-to-end
    metric the cell reports, less any whose `workloads` list leaves the cell
    out. A reader that finds nothing in the cell's record leaves its metric
    out of the line."""
    e2e = {m["name"] for m in end_to_end(man, cell, kind)}
    return [m for m in man["per_layer"]
            if m["moves"] in e2e and cell in m.get("workloads", [cell])]


def reader(root: str, metric: str):
    """benchmark/metrics/<metric>.py, whose read(record) gives the metric's
    value or None where the record holds nothing to read."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def problems(root: str, man: dict) -> list:
    """What in the manifest breaks the naming rules or names a missing file."""
    out = []
    names = [c["name"] for c in man["configs"]] + [w["name"] for w in man["workloads"]] \
        + [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    for n in names + [w["traffic"] for w in man["workloads"]] + [w["config"] for w in man["workloads"]]:
        if not NAME.match(n):
            out.append(f"bad name {n!r}")
    if len(set(names)) != len(names):
        out.append("a name is used twice")
    for m in man["end_to_end"] + man["per_layer"]:
        if not UNIT.match(m["unit"]) or m["better"] not in ("lower", "higher") \
                or m["source"] not in SOURCES:
            out.append(f"bad unit, better or source on {m['name']}")
    for c in man["configs"]:
        if not os.path.exists(os.path.join(root, c["file"])):
            out.append(f"missing config file {c['file']}")
    for w in man["workloads"]:
        path = os.path.join(root, "benchmark", "traffic", f"{w['traffic']}.json")
        if not os.path.exists(path):
            out.append(f"missing traffic {w['traffic']}")
            continue
        k = traffic(root, w["traffic"]).get("kind", "")
        if not NAME.match(k) or not os.path.exists(os.path.join(root, "benchmark", "kinds", f"{k}.py")):
            out.append(f"missing kind {k!r} of traffic {w['traffic']}")
    for m in man["per_layer"]:
        if not os.path.exists(os.path.join(root, "benchmark", "metrics", f"{m['name']}.py")):
            out.append(f"missing metric reader {m['name']}")
    return out
