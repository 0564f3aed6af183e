import json
import os
import shutil
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips (inside the test) where there is none")


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A checkout-like root holding a copy of the benchmark with every
    traffic cut to `samples` samples; examples/ is linked, and TMPDIR
    points inside it. Call it with the sample count."""
    def make(samples: int):
        root = tmp_path / "root"
        shutil.copytree(os.path.join(REPO, "benchmark"), root / "benchmark",
                        ignore=shutil.ignore_patterns("__pycache__", "tests"))
        shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root / "BENCHMARK.json")
        os.symlink(os.path.join(REPO, "examples"), root / "examples")
        for f in (root / "benchmark" / "traffic").iterdir():
            t = json.loads(f.read_text())
            t["samples"] = samples
            f.write_text(json.dumps(t))
        (tmp_path / "tmp").mkdir()
        monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
        return str(root)
    return make


# A floating-base walking cell with foot contacts, added to a tiny root by
# new files alone: the identify kind's contact path, on the repo's example
# humanoid, which no cell of BENCHMARK.json runs.
WALKING_CONFIG = {
    "name": "humanoid-example", "urdf": "examples/models/humanoid30.urdf",
    "structural_cache": "examples/models/humanoid30.urdf.regressor.npz",
    "assumed": ["the repo's example humanoid, for the tests only"],
}
WALKING_TRAFFIC = {
    "kind": "identify", "recording": "walking", "samples": 13770, "frequency": 200.0,
    "recordings": 3, "torque_noise": 0.05, "wrench_noise": 0.5,
    "contact_frames": ["L_foot_ft", "R_foot_ft"],
    "options": {
        "floatingBase": 1, "identifyFrictionSimultaneously": 1, "identifySymmetricVelFriction": 1,
        "frictionSignThreshold": 0.02, "constrainToConsistent": 1, "limitOverallMass": 1,
        "limitMassRange": 5.0, "limitMassToApriori": 1, "limitMassAprioriBoundary": 0.5,
        "cadRegularizationMode": "observability", "useStructuralRegressor": 1,
        "randomSamples": 2000, "materializeRegressor": 0, "gramChunk": 4096,
        "estimateWith": "std", "verbose": 0},
    "limits": {"gram_rel_err": 2e-06, "base_rows_rel_err": 3e-06, "resid_report_gap_pct": 0.0001,
               "resid_gap_pct": 0.0002, "inconsistency": 1e-09},
}
WALKING = "humanoid-example-walk-identify"


def add_walking_cell(root: str, samples: int) -> str:
    """Add the walking cell to a tiny root's files and manifest; its name."""
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "humanoid-example.json"), "w") as f:
        json.dump(WALKING_CONFIG, f)
    with open(os.path.join(b, "traffic", "walk-identify-example.json"), "w") as f:
        json.dump(dict(WALKING_TRAFFIC, samples=samples), f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["configs"].append({"name": "humanoid-example", "source": "https://example.org/humanoid",
                           "file": "benchmark/configs/humanoid-example.json", "reduced": [],
                           "why": "test"})
    man["workloads"].append({"name": WALKING, "config": "humanoid-example",
                             "traffic": "walk-identify-example", "chips": 1, "why": "test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return WALKING


@pytest.fixture
def cell_root(tiny_root):
    """A tiny root at `samples` samples that holds `cell`: one of the
    manifest's, or the walking cell added by new files."""
    def make(cell: str, samples: int = 1000) -> str:
        root = tiny_root(samples)
        if cell == WALKING:
            add_walking_cell(root, samples)
        return root
    return make
