"""Cells added as new files alone, with entries added to BENCHMARK.json and
no existing file edited, run on the CPU: a configuration, a traffic mix and
a per-layer metric of the identify kind; and a cell of a new kind, with its
own end-to-end and per-layer metrics."""

import hashlib
import json
import os

from benchmark.harness import runner


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                out[p] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def _add(root, section, entry):
    path = os.path.join(root, "BENCHMARK.json")
    man = json.load(open(path))
    man[section].append(entry)
    json.dump(man, open(path, "w"))


def test_a_cell_added_by_new_files_alone_runs(tiny_root):
    root = tiny_root(1000)
    before = _digests(root)
    b = os.path.join(root, "benchmark")
    cfg = json.load(open(os.path.join(b, "configs", "arm7.json")))
    cfg["name"] = "arm7-copy"
    json.dump(cfg, open(os.path.join(b, "configs", "arm7-copy.json"), "w"))
    mix = json.load(open(os.path.join(b, "traffic", "identify-N60000.json")))
    mix.update(samples=1200, recordings=2)
    json.dump(mix, open(os.path.join(b, "traffic", "identify-N1200.json"), "w"))
    _write(os.path.join(b, "metrics", "ols_ms.identify.py"),
           "def read(rec):\n"
           "    s = rec['trace'].span_seconds('ols_wls', 'estimateParameters')\n"
           "    return 1e3 * s / rec['units'] if s > 0 else None\n")
    _add(root, "configs", {"name": "arm7-copy", "source": "https://example.org/arm",
                           "file": "benchmark/configs/arm7-copy.json", "reduced": [], "why": "test"})
    _add(root, "workloads", {"name": "arm7-copy-identify-N1200", "config": "arm7-copy",
                             "traffic": "identify-N1200", "chips": 1, "why": "test"})
    _add(root, "per_layer", {"name": "ols_ms.identify", "unit": "ms", "better": "lower",
                             "source": "device_trace", "layer": "Orchestration",
                             "moves": "identify_s"})

    code, traced = runner.run(root, "arm7-copy-identify-N1200", 2**35, 1.0, True, device="cpu")
    assert code == 0 and traced["correct"], traced
    # the new metric, and the identify kind's that a CPU trace can read (it
    # has no device operations for the roofline and the idle share)
    assert {"ols_ms.identify", "regressor_gram_ms.identify", "sdp_ms.identify",
            "reporting_ms.identify"} <= set(traced["metrics"])
    code, timed = runner.run(root, "arm7-copy-identify-N1200", 2**35, 1.0, False, device="cpu")
    assert code == 0 and set(timed["metrics"]) == {"identify_s", "setup_s"}
    after = _digests(root)
    assert all(after[p] == h for p, h in before.items())


ECHO_KIND = '''"""Kind `echo`: each unit sums a vector drawn from the seed."""

import torch

from ..harness.trace import span

E2E = {"echo_s": "per_unit_s"}


class Cell:
    def __init__(self, root, config, traffic, seed, device, workdir):
        g = torch.Generator().manual_seed(seed)
        self.x = torch.randn(int(traffic["n"]), generator=g, dtype=torch.float64).to(device)

    def setup(self):
        yield "inputs", 0.0

    def unit(self, u):
        with span("sum"):
            return float(self.x.sum())

    def spans(self):
        return []

    def layer_record(self, window):
        return dict(units=len(window.walls))

    def release(self, window):
        pass

    def judge(self, window):
        ref = float(self.x.cpu().numpy().sum())
        return {"sum_gap": max(abs(o - ref) for o in window.outputs)}
'''


def test_a_cell_of_a_new_kind_added_by_new_files_alone_runs(tiny_root):
    root = tiny_root(1000)
    before = _digests(root)
    b = os.path.join(root, "benchmark")
    _write(os.path.join(b, "kinds", "echo.py"), ECHO_KIND)
    _write(os.path.join(b, "configs", "vector.json"),
           json.dumps({"name": "vector", "assumed": []}))
    _write(os.path.join(b, "traffic", "echo-1000.json"),
           json.dumps({"kind": "echo", "n": 1000, "limits": {"sum_gap": 1e-9}}))
    _write(os.path.join(b, "metrics", "sum_ms.echo.py"),
           "def read(rec):\n"
           "    s = rec['trace'].span_seconds('sum', None)\n"
           "    return 1e3 * s / rec['units'] if s > 0 else None\n")
    _add(root, "configs", {"name": "vector", "source": "https://example.org/vector",
                           "file": "benchmark/configs/vector.json", "reduced": [], "why": "test"})
    _add(root, "workloads", {"name": "vector-echo", "config": "vector", "traffic": "echo-1000",
                             "chips": 1, "why": "test"})
    _add(root, "end_to_end", {"name": "echo_s", "unit": "s", "better": "lower", "bound": 0.1,
                              "source": "host_clock", "workloads": ["vector-echo"]})
    _add(root, "per_layer", {"name": "sum_ms.echo", "unit": "ms", "better": "lower",
                             "source": "device_trace", "layer": "Echo", "moves": "echo_s"})

    code, timed = runner.run(root, "vector-echo", 2**35, 0.2, False, device="cpu")
    assert code == 0 and timed["correct"], timed
    assert set(timed["metrics"]) == {"echo_s", "setup_s"}
    code, traced = runner.run(root, "vector-echo", 2**35, 0.2, True, device="cpu")
    assert code == 0 and traced["correct"] and set(traced["metrics"]) == {"sum_ms.echo"}
    # the identify cells report as before
    code, timed = runner.run(root, "arm7-identify-N2000", 2**35, 0.5, False, device="cpu")
    assert code == 0 and timed["correct"] and {"identify_s", "setup_s"} <= set(timed["metrics"])
    after = _digests(root)
    assert all(after[p] == h for p, h in before.items())
