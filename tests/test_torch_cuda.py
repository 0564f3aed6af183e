"""Tests of the port that need a CUDA device (marker `cuda`).

They skip inside the test where there is no card. This file imports
neither JAX nor the JAX package's test helpers, so on a machine with a
card and no JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import os
import shutil

import numpy as np
import pytest
import torch

from flobaroid_tpu_torch.identification.identifier import Identification
from flobaroid_tpu_torch.ops import gram as tgram
from flobaroid_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("N,B,C", [(14000, 1, 80), (2000, 7, 82), (1037, 1, 37), (5, 3, 1)])
def test_gram_kernel_matches_plain(cuda_device, N, B, C):
    """Kernel vs the plain version in f64 on the same inputs: 1e-5 of
    max|G| (plain f32 FMA, row splits bound each sum chain)."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    Y = torch.randn((N, B, C), generator=g, device=cuda_device)
    before = tgram.launches
    Gk = tgram.gram_batched(Y)
    torch.cuda.synchronize()
    assert tgram.launches == before + 1
    G64 = tgram.gram_plain(Y.double())
    assert float((Gk.double() - G64).abs().max() / G64.abs().max()) <= 1e-5
    assert torch.equal(Gk, tgram.gram_batched(Y))  # no atomics: bitwise reproducible
    assert torch.equal(Gk, Gk.transpose(1, 2))
    Yt = Y.permute(1, 0, 2).contiguous().permute(1, 0, 2)  # strided view, no copy
    assert torch.equal(tgram.gram_batched(Yt), Gk)


def test_gram_wrapper_raises_instead_of_falling_back(cuda_device):
    Y = torch.randn((64, 2, 9), device=cuda_device)
    with pytest.raises(TypeError):
        tgram.gram_batched(Y.double())  # the kernel is f32 only
    with pytest.raises(ValueError):
        tgram.gram_batched(Y, out=torch.empty((2, 9, 9), device=cuda_device).transpose(1, 2))
    assert torch.equal(tgram.gram_batched(Y[:0]), torch.zeros((2, 9, 9), device=cuda_device))


def test_slice_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """The streamed identify on the card (kernel in both Gram sites)
    against the same port on the CPU (plain versions), on the checked-in
    structural cache so both use one projection."""
    urdf = str(tmp_path / "arm.urdf")
    shutil.copy(ARM_URDF, urdf)
    shutil.copy(ARM_URDF + ".regressor.npz", urdf + ".regressor.npz")
    opt = dict(floatingBase=0, simulateTorques=1, useStructuralRegressor=1, randomSamples=600,
               estimateWith="std", materializeRegressor=0, constrainToConsistent=1,
               limitOverallMass=1, limitMassRange=1.0, limitMassToApriori=1,
               limitMassAprioriBoundary=0.3, verbose=0, gramChunk=256)
    rng = np.random.default_rng(42)
    n, nd = 800, 7
    samples = dict(positions=rng.uniform(-1.5, 1.5, (n, nd)),
                   velocities=rng.standard_normal((n, nd)),
                   accelerations=rng.standard_normal((n, nd)) * 3,
                   torques=np.zeros((n, nd)), times=np.arange(n) / 200.0,
                   frequency=np.array(200.0))
    out = {}
    for dev in ("cuda", "cpu"):
        before = tgram.launches
        idf = Identification(load_config(None, overrides=opt), urdf, device=dev)
        idf.data.init_from_data(dict(samples))
        idf.estimateParameters()
        out[dev] = (idf, tgram.launches - before)
    (g, g_launches), (c, c_launches) = out["cuda"], out["cpu"]
    assert g.model.G_rows.device.type == "cuda"
    assert g_launches >= 4 and c_launches == 0  # ceil(800 / 256) chunks per pass
    assert g.sdp.last_status == c.sdp.last_status == "optimal"
    xg, xc = g.model.xBase, c.model.xBase
    assert np.linalg.norm(xg - xc) <= 1e-4 * np.linalg.norm(xc)
    assert abs(g.res_error - c.res_error) <= 1e-3
