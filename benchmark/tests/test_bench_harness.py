"""The frozen arithmetic of the harness: the window, the roofline counts,
the idle share of a trace, and the check for JAX modules."""

import os
import subprocess
import sys

import pytest
import torch

from benchmark.harness import modules, roofline, trace, window


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _window(walls, seconds):
    clock = Clock()
    it = iter(walls)

    def unit(u):
        clock.t += next(it)
        return u

    return window.run(unit, seconds, clock)


def test_window_runs_the_unit_in_flight_to_its_end():
    w = _window([0.5] * 30, 2.2)
    assert len(w.walls) == 5 and w.seconds == pytest.approx(2.5)
    assert w.per_unit_s == pytest.approx(0.5)
    assert w.outputs == [0, 1, 2, 3, 4]


def test_a_stall_moves_the_per_unit_time():
    steady = _window([0.5] * 30, 5.0)
    stalled = _window([0.5] * 3 + [4.0] + [0.5] * 30, 5.0)
    assert stalled.per_unit_s > 1.2 * steady.per_unit_s


def test_stalls_move_the_tail():
    steady = _window([0.1] * 300, 20.0)
    stalled = _window(([0.1] * 8 + [0.5] * 2) * 30, 20.0)
    assert steady.p90_s == pytest.approx(0.1)
    assert stalled.p90_s == pytest.approx(0.5) and stalled.per_unit_s > 1.5 * steady.per_unit_s
    assert _window([0.3], 0.1).p90_s == pytest.approx(0.3)


def test_a_failed_unit_counts_as_attempted():
    def unit(u):
        raise RuntimeError("broken")

    w = window.run(unit, 0.0)
    assert w.failed == 1 and w.outputs == [None] and len(w.walls) == 1


@pytest.mark.parametrize("shape,bound_us", [((4096, 36, 432), 84.1), ((1482, 36, 432), 35.5),
                                            ((4096, 7, 82), 2.86)])
def test_gram_bounds_match_the_kernel_table(shape, bound_us):
    assert roofline.gram_bound_s(*shape) * 1e6 == pytest.approx(bound_us, abs=0.051)


def test_chunks():
    assert roofline.chunks(13770, 4096) == [4096, 4096, 4096, 1482]
    assert roofline.chunks(60000, 4096) == [4096] * 14 + [2656]


def test_forbidden_modules_compare_whole_top_level_names():
    assert modules.forbidden_loaded(["flobaroid_tpu_torch.x", "flobaroid_tpu_torch", "jaxtyping"]) == []
    assert modules.forbidden_loaded(["flobaroid_tpu.x", "jax.numpy", "jaxlib", "os"]) == [
        "flobaroid_tpu.x", "jax.numpy", "jaxlib"]


class Ev:
    """A stand-in for a profiler event."""

    def __init__(self, name, start, dur, device=False, corr=0, thread=1, annotation=False):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._c, self._t, self._a = device, corr, thread, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._dev else torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._t

    def is_user_annotation(self):
        return self._a


def _synthetic():
    # window 0-1000 ns; host spans: sdp 100-400, gram_batched 500-600 inside
    # regressor_gram 450-900; kernels: 150-250 (sdp), 550-650 (gram, launched
    # at 510), 700-800 (launched at 720 in regressor_gram), one before the window
    return Trace([
        Ev("bench/window", 0, 1000, annotation=True),
        Ev("bench/sdp", 100, 300, annotation=True),
        Ev("bench/regressor_gram", 450, 450, annotation=True),
        Ev("bench/gram_batched", 500, 100, annotation=True),
        Ev("bench/gram_batched", 550, 100, device=True, corr=2, annotation=True),
        Ev("cudaLaunchKernel", 120, 5, corr=1),
        Ev("cudaLaunchKernel", 510, 5, corr=2),
        Ev("cudaLaunchKernel", 720, 5, corr=3),
        Ev("k_sdp", 150, 100, device=True, corr=1),
        Ev("k_gram", 550, 100, device=True, corr=2),
        Ev("k_reg", 700, 100, device=True, corr=3),
        Ev("k_before", -50, 20, device=True, corr=9),
    ])


Trace = trace.Trace


def test_idle_share_and_span_attribution_of_a_synthetic_trace():
    tr = _synthetic()
    assert tr.window_s == pytest.approx(1e-6)
    assert tr.busy_s == pytest.approx(300e-9)  # the span's device copy is no work
    assert tr.device_seconds_in("gram_batched") == pytest.approx(100e-9)
    assert tr.device_seconds_in("sdp") == pytest.approx(100e-9)
    assert tr.device_seconds_in("regressor_gram") == pytest.approx(100e-9)
    idle = dict(tr.idle_by_host_span(tr.main_thread()))
    # gaps 0-150, 250-550, 650-700 and 800-1000, split where the host's
    # innermost span changes: outside 0-100, 400-450 and 900-1000; sdp
    # 100-150 and 250-400; regressor_gram 450-500 and 650-700 and 800-900;
    # gram_batched 500-550
    assert idle == pytest.approx({"outside spans": 250e-9, "sdp": 200e-9,
                                  "regressor_gram": 200e-9, "gram_batched": 50e-9})
    assert [n for n, _ in tr.device_ops()] == ["k_sdp", "k_gram", "k_reg"]


def test_a_layer_span_runs_to_the_end_of_the_device_work_it_launched():
    # estimateParameters 0-1000 holds sdp 100-300 and 300-400 (a kernel
    # launched at 390 ends at 480), reporting 500-600 (its kernel ends at
    # 650) with a nested reporting 520-540, and a reporting 700-750 inside
    # ols_wls 650-800, which is not the stage's
    tr = Trace([
        Ev("bench/window", 0, 1000, annotation=True),
        Ev("bench/estimateParameters", 0, 1000, annotation=True),
        Ev("bench/sdp", 100, 200, annotation=True),
        Ev("bench/sdp", 300, 100, annotation=True),
        Ev("bench/reporting", 500, 100, annotation=True),
        Ev("bench/reporting", 520, 20, annotation=True),
        Ev("bench/ols_wls", 650, 150, annotation=True),
        Ev("bench/reporting", 700, 50, annotation=True),
        Ev("cudaLaunchKernel", 390, 5, corr=1),
        Ev("cudaLaunchKernel", 530, 5, corr=2),
        Ev("cudaLaunchKernel", 710, 5, corr=3),
        Ev("k1", 400, 80, device=True, corr=1),
        Ev("k2", 560, 90, device=True, corr=2),
        Ev("k3", 760, 100, device=True, corr=3),
    ])
    assert tr.span_seconds("sdp", "estimateParameters") == pytest.approx(380e-9)
    assert tr.span_seconds("reporting", "estimateParameters") == pytest.approx(150e-9)
    assert tr.span_seconds("reporting", "ols_wls") == pytest.approx(160e-9)
    assert tr.span_seconds("estimateParameters", None) == pytest.approx(1000e-9)
    assert tr.span_seconds("ols_wls", None) == 0


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(RuntimeError):
        Trace([Ev("k", 0, 10, device=True)])


def test_joined_windows_add_up():
    a, b = _window([0.5] * 4, 1.0), _window([0.25] * 8, 1.0)
    w = window.joined(a, b)
    assert w.seconds == pytest.approx(a.seconds + b.seconds) and len(w.walls) == 6
    assert w.per_unit_s == pytest.approx(w.seconds / 6)


def test_the_reference_and_the_inputs_load_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.identify_check, benchmark.inputs.recordings; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('flobaroid_tpu_torch', 'flobaroid_tpu', 'jax', 'jaxlib', 'flax')))")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         check=True, timeout=120)
    assert out.stdout.strip() == "[]"
