"""The correctness check fails where it must: the control (the reference in
the program's place at TF32) and a run whose timed path is broken
underneath, once for each fault an identification cell can have. (One
card per cell: there is no exchange between chips to leave out.)"""

import os

import pytest

from benchmark import control
from benchmark.harness import manifest, runner
from flobaroid_tpu_torch import model as model_mod
from flobaroid_tpu_torch.identification.identifier import Identification
from flobaroid_tpu_torch.ops import gram

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the manifest's cells, and the walking cell the tests add by new files
CELLS = [w["name"] for w in manifest.load(REPO)["workloads"]] + ["humanoid-example-walk-identify"]
SEED = 2**33 + 11


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, cell_root):
    root = cell_root(cell)
    for seed in (1, 2, 3):
        checks = control.control_numbers(root, cell, seed, "cpu")
        assert any(v["value"] > v["limit"] for v in checks.values()), checks


def _run(cell_root, cell):
    code, result = runner.run(cell_root(cell), cell, SEED, 1.0, False, device="cpu")
    assert code == 0
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, cell_root):
    assert _run(cell_root, cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_identification_that_returns_its_state_unchanged_is_caught(cell, cell_root, monkeypatch):
    real = Identification.estimateParameters
    calls = []

    def first_only(self, *a, **k):
        calls.append(1)
        if len(calls) == 1:
            real(self, *a, **k)

    monkeypatch.setattr(Identification, "estimateParameters", first_only)
    result = _run(cell_root, cell)
    assert not result["correct"] and result["checks"]["gram_rel_err"]["value"] > \
        result["checks"]["gram_rel_err"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_of_the_samples_left_out_is_caught(cell, cell_root, monkeypatch):
    def half(Y, out=None):
        return 2 * gram.gram_batched(Y[: Y.shape[0] // 2])

    monkeypatch.setattr(model_mod, "gram_batched", half)
    result = _run(cell_root, cell)
    assert not result["correct"] and result["checks"]["gram_rel_err"]["value"] > \
        result["checks"]["gram_rel_err"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced_is_caught(cell, cell_root, monkeypatch):
    real = Identification.estimateParameters

    def altered(self, *a, **k):
        real(self, *a, **k)
        m = self.model
        m.xStd = m.xStd.copy()
        k = max(i for i in range(m.num_links) if m.xStd[10 * i] > 0)
        m.xStd[10 * k] *= 1.01  # the last link's mass that is not 0, 1 % off

    monkeypatch.setattr(Identification, "estimateParameters", altered)
    result = _run(cell_root, cell)
    assert not result["correct"]


def test_the_limits_lie_where_the_manifest_says(tiny_root):
    root = tiny_root(1000)
    for w in manifest.load(root)["workloads"]:
        assert manifest.traffic(root, w["traffic"])["limits"]
