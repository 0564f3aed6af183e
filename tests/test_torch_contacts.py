"""The port's floating-base walking-contact identify against the JAX package.

humanoid30 (30 DOF, 34 links, three of them massless F/T frames) with
bench.py's second leg's options (`bench.py:90-98`: floating base,
symmetric friction, P = 430 identified columns) on 1000 walking samples
(identification needs N > 2P). The URDF and its checked-in structural
cache (fb=1, n=2000) are copied into a temporary directory, so both
packages read one structural projection. Everything runs in f64 on the
CPU, where the port's Gram wrapper runs its plain version.

Tolerances, relative to the largest entry (series) or the norm
(parameter vectors): samples, contact sums, Grams and validation series
1e-10 (same formulas, rounding order only); OLS xBase 1e-8; the bench
configuration with the SDP 1e-6 (the barrier's gap_rel is ~6e-7);
materialized against streamed 1e-6.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from flobaroid_tpu.identification.identifier import Identification as JaxIdentification
from flobaroid_tpu.simulation import scenarios as jax_scenarios
from flobaroid_tpu.utils.config import load_config
from flobaroid_tpu_torch.data import Data
from flobaroid_tpu_torch.identification.identifier import Identification
from flobaroid_tpu_torch.ops import gram as tgram
from flobaroid_tpu_torch.simulation import scenarios

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H30_URDF = os.path.join(REPO, "examples", "models", "humanoid30.urdf")
N = 1000
OLS = dict(
    floatingBase=1, identifyFrictionSimultaneously=1, identifySymmetricVelFriction=1,
    useStructuralRegressor=1, randomSamples=2000, estimateWith="std",
    constrainToConsistent=0, materializeRegressor=0, gramChunk=512,
    computeDtype="float64", verbose=0,
)
BENCH = dict(  # bench.py:90-98
    OLS, constrainToConsistent=1, limitOverallMass=1, limitMassRange=5.0,
    limitMassToApriori=1, limitMassAprioriBoundary=0.5,
    cadRegularizationMode="observability",
)


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _rel_norm(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def h30(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_contacts")
    shutil.copy(H30_URDF, d)
    shutil.copy(H30_URDF + ".regressor.npz", d)
    return str(d / "humanoid30.urdf")


@pytest.fixture(scope="module")
def walk(h30):
    """The port's noisy (bench noise levels) and clean walking scenarios,
    and the JAX package's noisy one from the same seed."""
    gen = Identification(load_config(None, overrides=OLS), h30, device="cpu")
    noisy = scenarios.walking_contact_scenario(
        gen.model, N=N, seed=0, torque_noise=0.05, wrench_noise=0.5)
    clean = scenarios.walking_contact_scenario(gen.model, N=N, seed=3)
    jgen = JaxIdentification(load_config(None, overrides=OLS), h30)
    jax_noisy = jax_scenarios.walking_contact_scenario(
        jgen.model, N=N, seed=0, torque_noise=0.05, wrench_noise=0.5)
    return dict(noisy=noisy, clean=clean, jax_noisy=jax_noisy)


def _identify(cls, urdf, samples, validation_file=None, **over):
    opt = load_config(None, overrides={**OLS, **over})
    kw = {} if cls is JaxIdentification else dict(device="cpu")
    idf = cls(opt, urdf, validation_file=validation_file, **kw)
    idf.data.init_from_data(dict(samples))
    idf.estimateParameters()
    return idf


@pytest.fixture(scope="module")
def streamed(h30, walk):
    """(JAX, port) streamed OLS identifies of the noisy scenario, chunks
    of 512 samples (two chunks, the second a 488-sample tail)."""
    s = walk["noisy"][0]
    return _identify(JaxIdentification, h30, s), _identify(Identification, h30, s)


@pytest.fixture(scope="module")
def materialized(h30, walk, tmp_path_factory):
    """(JAX, port) materialized OLS identifies of the noisy scenario with
    Ayusawa's base-wrench rows for the base parameters (materialized
    only), and a held-out validation file: the clean motion with
    joint-only torques (no contact contribution), so the 6 base rows are
    padded."""
    s, tau_full, _ = walk["clean"]
    v = {k: s[k] for k in ("positions", "velocities", "accelerations", "times", "frequency",
                           "base_rpy", "base_position", "base_velocity", "base_acceleration")}
    v["torques"] = tau_full[:, 6:]
    vf = str(tmp_path_factory.mktemp("torch_contacts_val") / "val.npz")
    np.savez(vf, **v)
    out = []
    for cls in (JaxIdentification, Identification):
        idf = _identify(cls, h30, walk["noisy"][0], validation_file=vf, materializeRegressor=1,
                        useBaseWrenchForBaseParams=1)
        idf.estimateValidationTorques()
        out.append(idf)
    return tuple(out)


@pytest.fixture(scope="module")
def materialized_ols(h30, walk):
    """The port's materialized OLS identify of the noisy scenario."""
    return _identify(Identification, h30, walk["noisy"][0], materializeRegressor=1)


@pytest.mark.timeout(120)
def test_twist_from_rpy_series_matches_jax():
    rng = np.random.default_rng(11)
    rpy, rpy_d, rpy_dd = (rng.standard_normal((64, 3)) * s for s in (0.3, 1.0, 3.0))
    wj, dwj = jax_scenarios.twist_from_rpy_series(rpy, rpy_d, rpy_dd)
    wt, dwt = scenarios.twist_from_rpy_series(rpy, rpy_d, rpy_dd)
    assert _rel(wt, wj) < 1e-10 and _rel(dwt, dwj) < 1e-10


def _assert_samples_match(st, sj):
    assert set(st) == set(sj)
    for k, v in sj.items():
        if k == "contacts":
            cj, ct = v.item(0), st[k].item(0)
            assert list(ct) == list(cj)
            for f in cj:
                assert _rel(ct[f], cj[f]) < 1e-10, f
        else:
            assert np.shape(st[k]) == np.shape(v), k
            assert _rel(st[k], v) < 1e-10, k


@pytest.mark.timeout(120)
@pytest.mark.parametrize("case", ["walking", "imu"])
def test_walking_scenario_matches_jax(h30, walk, case):
    """One seed gives the same samples, noise-free inverse dynamics and
    true contact contributions J^T w in both packages (the numpy draws in
    the same order; the port's inverse dynamics and frame Jacobians)."""
    if case == "walking":
        out_t, out_j = walk["noisy"], walk["jax_noisy"]
    else:
        # N as in the walking case, so the JAX package reuses its compiled
        # simulation
        kw = dict(N=N, seed=21, imu=True, torque_noise=0.02, wrench_noise=0.3)
        gen = Identification(load_config(None, overrides=OLS), h30, device="cpu")
        jgen = JaxIdentification(load_config(None, overrides=OLS), h30)
        out_t = scenarios.walking_contact_scenario(gen.model, **kw)
        out_j = jax_scenarios.walking_contact_scenario(jgen.model, **kw)
    _assert_samples_match(out_t[0], out_j[0])
    assert _rel(out_t[1], out_j[1]) < 1e-10 and _rel(out_t[2], out_j[2]) < 1e-10


@pytest.mark.timeout(120)
@pytest.mark.parametrize("mode", ["streamed", "materialized"])
def test_contact_forces_sum_matches_truth(h30, walk, mode):
    """computeRegressors' contact block reproduces the generating J^T w
    on every row and stacks tau = Y pi + cf."""
    samples, tau_full, cf_true = walk["clean"]
    idf = Identification(load_config(None, overrides={
        **OLS, "materializeRegressor": int(mode == "materialized")}), h30, device="cpu")
    data = Data(idf.opt)
    data.init_from_data(dict(samples))
    idf.model.computeRegressors(data)
    cf = idf.model.contactForcesSum.reshape(N, -1)
    assert _rel(cf, cf_true) < 1e-10
    want = tau_full + cf_true
    assert _rel(idf.model.torques_stack.reshape(N, -1), want) < 1e-10


@pytest.mark.timeout(120)
def test_contact_forces_sum_matches_jax(streamed):
    j, t = streamed
    assert _rel(t.model.contactForcesSum, np.asarray(j.model.contactForcesSum)) < 1e-10
    assert _rel(t.model.tauMeasured, j.model.tauMeasured) < 1e-10


@pytest.mark.timeout(120)
def test_contacts_reentry_guard(h30, walk):
    """A second computeRegressors pass over the same Data must not add
    the contact contribution twice."""
    idf = Identification(load_config(None, overrides=OLS), h30, device="cpu")
    data = Data(idf.opt)
    data.init_from_data(dict(walk["clean"][0]))
    idf.model.computeRegressors(data)
    first = np.array(idf.model.torques_stack)
    assert data.contacts_in_torques
    idf.model.computeRegressors(data)
    assert np.allclose(idf.model.torques_stack, first)


@pytest.mark.timeout(120)
def test_skipsamples_leaves_measurements_pristine(h30, walk):
    """skipSamples > 0 with contacts: the subsampled torque write-back
    must not mutate data.measurements."""
    idf = Identification(load_config(None, overrides={**OLS, "skipSamples": 1}), h30,
                         device="cpu")
    data = Data(idf.opt)
    data.init_from_data(dict(walk["clean"][0]))
    orig = np.array(data.measurements["torques"])
    idf.model.computeRegressors(data)
    assert data.measurements["torques"].shape == orig.shape
    assert np.allclose(data.measurements["torques"], orig)
    assert data.samples["torques"].shape[0] == data.num_used_samples == N // 2


@pytest.mark.timeout(120)
def test_streamed_walk_grams_match_jax(streamed):
    """The numbers of the JAX package's fused walking scan: per-channel
    G/g/gcf, the tau/cf square sums, the a-priori residual statistics."""
    j, t = streamed
    jm, tm = j.model, t.model
    assert tm.G_rows.shape == (36, 430, 430)
    for name in ("G_rows", "g_rows", "gcf_rows"):
        assert _rel(getattr(tm, name).numpy(), np.asarray(getattr(jm, name))) < 1e-10, name
    for name in ("tau_sq_rows", "tau_cf_rows", "cf_sq_rows", "G_base", "g_base", "g_cf_base"):
        assert _rel(getattr(tm, name), getattr(jm, name)) < 1e-10, name
    x_ap = jm.xStdModel[jm.identified_params]
    sj, st = jm.residual_stats([x_ap])[0], tm.residual_stats([x_ap])[0]
    for k in ("rp", "pp", "tp"):
        assert _rel(st[k], sj[k]) < 1e-10, k
    assert abs(st["bn"] - sj["bn"]) <= 1e-10 * sj["bn"]


@pytest.mark.timeout(120)
def test_identify_ols_matches_jax(streamed):
    j, t = streamed
    assert t.model.num_base_params == j.model.num_base_params == 310
    assert _rel_norm(t.model.xBase, j.model.xBase) < 1e-8
    assert abs(t.res_error - j.res_error) < 1e-8 * j.res_error


@pytest.mark.timeout(120)
def test_identify_bench_configuration_matches_jax(h30, walk):
    """bench.py's second leg (SDP with mass limits and observability
    regularization): both optimal, xBase within the barrier's gap."""
    s = walk["noisy"][0]
    j = _identify(JaxIdentification, h30, s, **BENCH)
    t = _identify(Identification, h30, s, **BENCH)
    assert t.sdp.last_status == j.sdp.last_status == "optimal"
    assert _rel_norm(t.model.xBase, j.model.xBase) < 1e-6
    assert abs(t.res_error - j.res_error) < 1e-6 * j.res_error
    # the three massless F/T frames are pinned by the SDP, not constrained
    massless = {t.model.linkNames.index(n) for n in ("crane_ft", "L_foot_ft", "R_foot_ft")}
    assert massless <= t.sdp.pinned_links


@pytest.mark.timeout(120)
def test_materialized_matches_jax_and_streamed(materialized, materialized_ols, streamed):
    """The stacked regressor against the JAX package's; the materialized
    OLS identify against the streamed one of both packages."""
    (jm, tm), (js, ts), t = materialized, streamed, materialized_ols
    assert tm.model.YStd.shape == (N * 36, 430)
    assert _rel(tm.model.YStd, jm.model.YStd) < 1e-10
    assert _rel_norm(t.model.xBase, js.model.xBase) < 1e-8
    assert _rel_norm(t.model.xBase, ts.model.xBase) < 1e-6


@pytest.mark.timeout(120)
def test_heldout_validation_matches_jax(materialized):
    j, t = materialized
    assert t.tauMeasuredValidation.shape == (N // 9, 36)
    for name in ("tauEstimatedValidation", "tauMeasuredValidation", "Tv"):
        assert _rel(getattr(t, name), getattr(j, name)) < 1e-10, name
    # the padded base rows compare trivially equal
    np.testing.assert_array_equal(t.tauMeasuredValidation[:, :6], t.tauEstimatedValidation[:, :6])
    for name in ("val_error", "val_residual", "val_nrms"):
        assert abs(getattr(t, name) - getattr(j, name)) <= 1e-10 * abs(getattr(j, name)), name


@pytest.mark.timeout(120)
def test_base_wrench_for_base_params_matches_jax(h30, walk, materialized):
    """Ayusawa's base-wrench rows (materialized only): the same xBase as
    the JAX package; streaming raises as in the JAX package."""
    j, t = materialized
    assert t._bw_contactForcesSum.shape == (N * 6,)
    assert _rel_norm(t.model.xBase, j.model.xBase) < 1e-8
    with pytest.raises(ValueError, match="materializeRegressor=1"):
        _identify(Identification, h30, walk["noisy"][0], useBaseWrenchForBaseParams=1)


@pytest.mark.timeout(120)
def test_structural_cache_is_keyed_on_the_floating_base(h30):
    """A floating-base model reads the checked-in cache (fb=1) without a
    Gram launch, at its f64 stamp: rank 310, the JAX model's projection."""
    before = tgram.launches
    t = Identification(load_config(None, overrides=OLS), h30, device="cpu").model
    j = JaxIdentification(load_config(None, overrides=OLS), h30).model
    assert tgram.launches == before
    assert t.fb == 6 and t.N_OUT == 36 and t.num_identified_params == 430
    assert t._structural_gram_dtype == np.float64
    assert t.num_base_params == j.num_base_params == 310
    assert np.array_equal(t.Pb, j.Pb) and np.array_equal(t.K, j.K)
