"""benchmark/spans.py's attribution of a traced window to the program's
spans, and the readers built on it, on synthetic profiler events."""

import types

import pytest
import torch

from benchmark import harness, spans
from benchmark.tests import tiny

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA
MAIN, AUTOGRAD = 1, 2


def _event(name, start, end, device=CPU, id=0, thread=MAIN):
    return types.SimpleNamespace(
        name=name, device_type=device, id=id, thread=thread,
        time_range=types.SimpleNamespace(start=start, end=end))


def _launch(id, t, thread=MAIN):
    """A launch call at host time t and its kernel, 10 µs long, later."""
    return (_event("cudaLaunchKernel", t, t + 1, id=id, thread=thread),
            _event(f"kernel{id}", 1000 + 20 * id, 1010 + 20 * id, CUDA, id))


def _train_window():
    """One step: a forward with a cast under aten::copy_, a backward whose
    kernel the autograd thread launches, the optimizer, a sync in the
    head's rows; and a kernel launched outside every span."""
    host = [_event("train_step", 0, 100), _event("data:augment", 2, 8),
            _event("pfc_head:rows", 8, 10),
            _event("encoder:forward", 10, 30),
            _event("encoder:backward", 40, 70),
            _event("optim:encoder", 72, 80),
            _event("aten::copy_", 11, 14),
            # the main thread's copy_ holds no launch of the autograd
            # thread's
            _event("aten::copy_", 44, 47),
            _event("aten::index", 8.2, 9.9),
            _event("aten::nonzero", 8.5, 9.8),
            _event("cudaStreamSynchronize", 9, 9.5),
            _event("cudaStreamSynchronize", 150, 151)]
    launches = [_launch(1, 12), _launch(2, 20), _launch(3, 45, AUTOGRAD),
                _launch(4, 5), _launch(5, 75), _launch(6, 90),
                _launch(7, 120)]
    calls = [c for c, _ in launches]
    kernels = [k for _, k in launches]
    return host + calls + kernels, kernels


def _trace(events, kernels, steps=1):
    return types.SimpleNamespace(events=events, kernels=kernels,
                                 steps=steps)


def test_a_kernel_belongs_to_the_spans_that_hold_its_launch_call():
    events, kernels = _train_window()
    ids = lambda got: sorted(k.id for k in got)  # noqa: E731
    assert ids(spans.launched_in(events, kernels,
                                 [spans.ENCODER_FORWARD])) == [1, 2]
    # launched by the autograd engine's thread inside the main thread's
    # span
    assert ids(spans.launched_in(events, kernels,
                                 [spans.ENCODER_BACKWARD])) == [3]
    assert ids(spans.launched_in(events, kernels,
                                 [spans.TRAIN_STEP])) == [1, 2, 3, 4, 5, 6]
    assert spans.launched_in(events, kernels, [spans.EMBED_STEP]) is None
    fwd_bwd = spans.launched_in(
        events, kernels, [spans.ENCODER_FORWARD, spans.ENCODER_BACKWARD])
    assert ids(spans.under_op(events, fwd_bwd)) == [1]
    trace = _trace(events, kernels, steps=2)
    assert spans.device_ms_per_step(trace, [spans.ENCODER_FORWARD]) == \
        pytest.approx(0.010)
    assert spans.device_ms_per_step(
        trace, [spans.ENCODER_FORWARD, spans.ENCODER_BACKWARD],
        copies=True) == pytest.approx(0.005)


def test_breakdown_by_innermost_span_and_outside():
    events, kernels = _train_window()
    got = spans.breakdown(events, kernels, 1)
    assert got["device_ms"] == pytest.approx({
        spans.ENCODER_FORWARD: 0.02, spans.ENCODER_BACKWARD: 0.01,
        spans.AUGMENT: 0.01, spans.OPTIM_ENCODER: 0.01,
        spans.TRAIN_STEP: 0.01, spans.OUTSIDE: 0.01})
    assert got["launches"] == {
        spans.ENCODER_FORWARD: 2, spans.ENCODER_BACKWARD: 1,
        spans.AUGMENT: 1, spans.OPTIM_ENCODER: 1, spans.TRAIN_STEP: 1,
        spans.OUTSIDE: 1}
    assert got["outside_ops"] == [["kernel7", pytest.approx(0.01)]]
    assert got["syncs"] == [
        ["cudaStreamSynchronize", spans.OUTSIDE, "none", 1.0],
        ["cudaStreamSynchronize", "pfc_head:rows",
         "aten::index > aten::nonzero", 1.0]]
    # the device idles from the window's start to the first kernel (the
    # host's spans end at 100 µs, so the rest is outside every span), and
    # 10 µs between kernels
    idle = got["idle_ms"]
    assert sum(idle.values()) == pytest.approx((1020 - 0 + 6 * 10) / 1e3)
    assert idle[spans.ENCODER_FORWARD] == pytest.approx(0.020)
    assert idle[spans.TRAIN_STEP] == pytest.approx(
        (2 + 10 + 2 + 20) / 1e3)


def test_syncs_count_inside_the_step_only():
    events, _ = _train_window()
    found = spans.host_syncs(events)
    assert [e.time_range.start for e in found] == [9]
    assert spans.host_syncs(events, spans.EMBED_STEP) is None


def _embed_window():
    host = [_event("embed_step", 0, 50), _event("embed:copy_in", 1, 10),
            _event("embed:encoder", 10, 40), _event("aten::copy_", 15, 18)]
    launches = [_launch(1, 2), _launch(2, 16), _launch(3, 30),
                _launch(4, 60)]
    kernels = [k for _, k in launches]
    return host + [c for c, _ in launches] + kernels, kernels


TRAIN = ["encoder_fwd_ms_per_step", "encoder_bwd_ms_per_step",
         "encoder_copy_ms_per_step", "augment_ms_per_step",
         "optim_ms_per_step", "host_syncs_per_step.train"]
EMBED = ["encoder_ms_per_call.embed", "encoder_copy_ms_per_call.embed",
         "copy_in_ms_per_call.embed"]
WANT = {"encoder_fwd_ms_per_step": 0.02, "encoder_bwd_ms_per_step": 0.01,
        "encoder_copy_ms_per_step": 0.01, "augment_ms_per_step": 0.01,
        "optim_ms_per_step": 0.01, "host_syncs_per_step.train": 1.0,
        "encoder_ms_per_call.embed": 0.02,
        "encoder_copy_ms_per_call.embed": 0.01,
        "copy_in_ms_per_call.embed": 0.01}


@pytest.mark.parametrize("name", TRAIN + EMBED)
def test_reader_reads_a_trace_and_nothing_without_one(name):
    read = harness.metric_reader(tiny.ROOT, name)
    kind = "train" if name in TRAIN else "embed"
    window = _train_window() if kind == "train" else _embed_window()
    run = types.SimpleNamespace(kind=kind, trace=None)
    assert read(run) is None
    run.trace = _trace(*window)
    assert read(run) == pytest.approx(WANT[name])
    run.trace = _trace(window[0], [])
    assert read(run) is None
    # a window of the other kind, where the span never opened: no reading,
    # not 0
    other = _embed_window() if kind == "train" else _train_window()
    run.trace = _trace(*other)
    assert read(run) is None
    run.kind = "embed" if kind == "train" else "train"
    run.trace = _trace(*window)
    assert read(run) is None


def test_span_report_needs_a_card():
    from benchmark import span_report
    if torch.cuda.is_available():
        pytest.skip("runs a cell where a card is found")
    assert span_report.main(["--workload", "r100_wf42m.embed", "--seed",
                             "1", "--seconds", "1"]) == 3
