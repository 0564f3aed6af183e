"""The port's reports (flobaroid_tpu_torch/output.py) and parameter
helpers against the JAX package's, on the CPU in f64.

One identification per package on the same 900 noisy random-state
samples (tests/test_output.py's recipe: constrainToConsistent 0,
estimateWith std, a validation file), both on the checked-in structural
cache of the arm (randomSamples 600, no friction columns) copied with
the URDF, so both use one projection. The console report is compared
line by line: the text between numbers exactly, every number at 1e-6
relative. The HTML report must hold the JAX report's figure set, the
TikZ export its structure (the numbers aside).
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from flobaroid_tpu import output as jax_output
from flobaroid_tpu.identification.identifier import Identification as JaxIdentification
from flobaroid_tpu.utils import helpers as jax_helpers
from flobaroid_tpu.utils.config import load_config
from flobaroid_tpu_torch import output
from flobaroid_tpu_torch.identification.identifier import Identification
from flobaroid_tpu_torch.utils import helpers

from test_identification import synth_samples

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


@pytest.mark.parametrize("seed", [0, 1])
def test_param_helpers_match_jax(seed):
    """consistency_per_link, params_link_to_bary and params_bary_to_link
    on random parameter vectors (4 links, one massless, one with a
    negative mass): 1e-12."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=43)
    p[10:20] = 0.0
    p[30] = -abs(p[30])
    nmp = 40
    for fn in ("params_link_to_bary", "params_bary_to_link"):
        np.testing.assert_allclose(getattr(helpers, fn)(p, nmp), getattr(jax_helpers, fn)(p, nmp),
                                   rtol=1e-12, atol=1e-12)
    roundtrip = helpers.params_bary_to_link(helpers.params_link_to_bary(p, nmp), nmp)
    np.testing.assert_allclose(roundtrip[:nmp][p[:nmp:10].repeat(10) != 0],
                               p[:nmp][p[:nmp:10].repeat(10) != 0], rtol=1e-12, atol=1e-12)
    for triangle in (False, True):
        assert (helpers.consistency_per_link(p, 4, triangle=triangle)
                == jax_helpers.consistency_per_link(p, 4, triangle=triangle))


@pytest.fixture(scope="module")
def idfs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_out")
    shutil.copy(ARM_URDF, d)
    shutil.copy(ARM_URDF + ".regressor.npz", d)
    urdf = str(d / "sevenlink_arm.urdf")
    samples, _ = synth_samples(ARM_URDF, n=900, noise=0.02)
    f = d / "m.npz"
    np.savez(f, **samples)
    out = {}
    for name in ("jax", "port"):
        opt = load_config(None, overrides=dict(
            floatingBase=0, verbose=0, useStructuralRegressor=1, randomSamples=600,
            identifyFrictionSimultaneously=0, computeDtype="float64", estimateWith="std",
            constrainToConsistent=0, startOffset=0, outputFilename=str(d / f"{name}.html")))
        if name == "jax":
            idf = JaxIdentification(opt, urdf, urdf_file_real=ARM_URDF,
                                    measurements_files=[[str(f)]], validation_file=str(f))
        else:
            idf = Identification(opt, urdf, urdf_file_real=ARM_URDF,
                                 measurements_files=[[str(f)]], validation_file=str(f),
                                 device="cpu")
        idf.estimateParameters()
        idf.estimateValidationTorques()
        out[name] = idf
    assert np.array_equal(out["port"].model.Pb, np.asarray(out["jax"].model.Pb))
    return out


def _assert_same_text(port: str, jax: str, rtol: float = 1e-6) -> None:
    """Label text exactly, every number token within rtol."""
    lp, lj = port.splitlines(), jax.splitlines()
    assert len(lp) == len(lj)
    for a, b in zip(lp, lj):
        assert NUMBER.split(a) == NUMBER.split(b), (a, b)
        na = [float(x) for x in NUMBER.findall(a)]
        nb = [float(x) for x in NUMBER.findall(b)]
        assert len(na) == len(nb), (a, b)
        for x, y in zip(na, nb):
            assert abs(x - y) <= rtol * max(abs(x), abs(y)), (a, b)


@pytest.mark.parametrize("barycentric", [0, 1], ids=["link_frame", "barycentric"])
def test_console_report_matches_jax(idfs, barycentric, capsys):
    for idf in idfs.values():
        idf.opt["outputBarycentric"] = barycentric
    try:
        tp = output.OutputConsole(idfs["port"]).render()
        tj = jax_output.OutputConsole(idfs["jax"]).render()
    finally:
        for idf in idfs.values():
            idf.opt["outputBarycentric"] = 0
    assert "validation:" in tp and "torque estimation error" in tp
    assert ("barycentric" in tp) == bool(barycentric)
    _assert_same_text(tp, tj)


def test_latex_table_matches_jax(idfs):
    tp = output.OutputConsole(idfs["port"]).render_latex()
    assert "\\begin{tabular}" in tp
    _assert_same_text(tp, jax_output.OutputConsole(idfs["jax"]).render_latex())


def test_html_report_has_the_jax_figure_set(idfs, tmp_path):
    """OutputMatplotlib.render writes HTML with the JAX report's figures
    (the validation torques included), one SVG each, and the console text."""
    import matplotlib.pyplot as plt

    path = tmp_path / "port.html"
    html = output.OutputMatplotlib(idfs["port"], text="console <text>").render(str(path))
    assert path.exists() and path.read_text() == html
    jax_figures = jax_output.OutputMatplotlib(idfs["jax"])._figures()
    for _, fig in jax_figures:
        plt.close(fig)
    titles = re.findall(r"<h2>(.*?)</h2>", html)
    assert titles == [t for t, _ in jax_figures] + ["Console output"]
    assert "Validation torques" in titles
    assert html.count("<svg") == len(jax_figures)
    assert "console &lt;text>" in html


def test_tikz_export_has_the_jax_structure(idfs, tmp_path):
    """render_tikz: the same axes, plots and legend entries as the JAX
    export, line for line with the numbers aside; outputAs tikz flows
    through render()."""
    tp = output.OutputMatplotlib(idfs["port"]).render_tikz(str(tmp_path / "p.tex"))
    tj = jax_output.OutputMatplotlib(idfs["jax"]).render_tikz(str(tmp_path / "j.tex"))
    assert (tmp_path / "p.tex").exists()
    assert tp.count("\\begin{axis}") == 2 * idfs["port"].model.num_dofs
    body_p, body_j = tp.splitlines()[1:], tj.splitlines()[1:]  # line 0 names the package
    assert [NUMBER.sub("#", s) for s in body_p] == [NUMBER.sub("#", s) for s in body_j]
    idf = idfs["port"]
    idf.opt.update(outputAs="tikz", outputFilename=str(tmp_path / "r.html"))
    try:
        output.OutputMatplotlib(idf).render()
    finally:
        idf.opt["outputAs"] = "html"
    assert (tmp_path / "r.tex").exists()


def test_report_takes_tensors_at_its_boundary(idfs):
    """Arrays handed to the report as tensors are turned into numpy once:
    the console text is the one of the numpy arrays."""
    idf = idfs["port"]
    m = idf.model
    text = output.OutputConsole(idf).render()
    keys = ("xBase", "xBaseModel", "tauMeasured", "T")
    saved = {k: getattr(m, k) for k in keys}
    for k in keys:
        setattr(m, k, torch.as_tensor(saved[k]))
    try:
        assert output.OutputConsole(idf).render() == text
        assert len(output.OutputMatplotlib(idf).render_tikz()) > 0
    finally:
        for k in keys:
            setattr(m, k, saved[k])
