"""The plain reference against the port on the CPU, and each cell run end
to end on the CPU at a tiny size, judged by the cell's own limits."""

import os

import numpy as np
import pytest
import torch

from benchmark.harness import manifest, runner
from benchmark.inputs import recordings
from benchmark.reference import rigid_body as rb
from flobaroid_tpu_torch.dynamics.engine import DynamicsEngine, rpy_to_base_rot
from flobaroid_tpu_torch.models.urdf import load_urdf
from flobaroid_tpu_torch.simulation.scenarios import twist_from_rpy_series

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MAN = manifest.load(REPO)
# the manifest's cells, and the walking cell the tests add by new files
CELLS = [w["name"] for w in MAN["workloads"]] + ["humanoid-example-walk-identify"]
URDFS = [manifest.config(REPO, MAN, c["name"])["urdf"] for c in MAN["configs"]] + [
    "examples/models/humanoid30.urdf"]


@pytest.mark.parametrize("urdf", URDFS)
def test_reference_dynamics_match_the_port(urdf):
    urdf = os.path.join(REPO, urdf)
    robot, tree = rb.load_urdf(urdf), load_urdf(urdf)
    engine = DynamicsEngine(tree)
    assert robot.link_names == tree.link_names and robot.dof_names == list(tree.dof_names)
    np.testing.assert_allclose(robot.params.ravel(), tree.std_params(), atol=1e-12)
    g = torch.Generator().manual_seed(3)
    N, n = 40, robot.num_dofs
    Q, V, A = (torch.randn(N, n, generator=g, dtype=torch.float64) for _ in range(3))
    Yr = rb.regressor(robot, Q, V, A)
    torch.testing.assert_close(Yr, engine.regressor_batch(Q, V, A), atol=1e-12, rtol=1e-12)
    rpy = 0.3 * torch.randn(N, 3, generator=g, dtype=torch.float64)
    BV, BA = (torch.randn(N, 6, generator=g, dtype=torch.float64) for _ in range(2))
    BR = rpy_to_base_rot(rpy)
    torch.testing.assert_close(rb.rpy_matrix_t(rpy).transpose(-1, -2), BR)
    Yr = rb.regressor(robot, Q, V, A, (BR, BV, BA))
    torch.testing.assert_close(Yr, engine.regressor_batch(Q, V, A, BR, BV, BA), atol=1e-11, rtol=1e-11)
    w = torch.randn(N, 6, generator=g, dtype=torch.float64)
    link = robot.num_links - 1
    torch.testing.assert_close(rb.contact_torques(robot, link, Q, BR, w),
                               (w[:, None, :] @ engine.frame_jacobian(link, Q, BR))[:, 0])


def test_base_twist_matches_the_port():
    rng = np.random.default_rng(0)
    a = [0.5 * rng.normal(size=(30, 3)) for _ in range(3)]
    for mine, port in zip(recordings._base_twist(*a), twist_from_rpy_series(*a)):
        np.testing.assert_allclose(mine, port, atol=1e-13)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_cpu(cell, cell_root):
    code, result = runner.run(cell_root(cell), cell, 2**33 + 5, 1.0, False, device="cpu")
    assert code == 0 and result["correct"], result
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"


def test_a_cpu_host_reports_nothing_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    code, result = runner.run(REPO, CELLS[0], 1, 1.0, False)
    assert code != 0 and result is None


@pytest.mark.cuda
def test_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    code, result = runner.run(REPO, "arm7-identify-N60000", 2**33 + 7, 2.0, True)
    assert code == 0 and result["correct"], result
    assert {"device_idle_pct.identify", "gram_roofline_pct.identify", "regressor_gram_ms.identify",
            "sdp_ms.identify", "reporting_ms.identify"} <= set(result["metrics"])
