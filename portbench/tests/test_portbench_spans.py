"""The span trace's books on synthetic event lists (``core/spans.py``):
launches, blocking calls and idle gaps put down to the innermost span open
on the host, totals over nested spans, a gap split across two spans and
one outside every span, launches from another thread during ``backward``;
and the readers of the span metrics, which read nothing from an untraced
record and start no span trace outside a run of their cell."""
import subprocess
import sys
import types

import pytest
import torch

from portbench.core import spec, spans

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class _Raw:
    """A raw profiler event as ``events_of`` reads it (µs in, ns out)."""

    def __init__(self, name, start, end, device=CPU, annotation=False,
                 thread=1):
        self._n, self._s, self._e = name, start, end
        self._d, self._a, self.thread = device, annotation, thread

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return int(self._s * 1000)

    def end_ns(self):
        return int(self._e * 1000)

    def is_user_annotation(self):
        return self._a


def _span(name, start, end):
    return _Raw(spans.PREFIX + name, start, end, annotation=True)


def _launch(t, i, kernel_start, kernel_end, call="cudaLaunchKernel",
            thread=1):
    """A launch call at ``t`` and the kernel ``i`` it launched."""
    return [_Raw(call, t, t + 1, thread=thread),
            _Raw(f"kernel_{i}", kernel_start, kernel_end, device=CUDA)]


def _summary(raw, steps=1):
    return spans.summarize(*spans.events_of(raw), steps, 1.0)


def test_nested_spans_credit_the_innermost_and_total_every_open_one():
    raw = [_span("step", 0, 100), _span("decoder", 10, 90),
           _span("decoder.iter", 20, 40), _span("decoder.iter", 50, 70),
           # the range a span also leaves on the device is no launch
           _Raw(spans.PREFIX + "step", 0, 100, device=CUDA,
                annotation=True)]
    raw += _launch(5, 1, 6, 30)          # step
    raw += _launch(15, 2, 30, 45)        # decoder, between iterations
    raw += _launch(25, 3, 45, 52)        # first iteration
    raw += _launch(55, 4, 60, 80)        # second iteration
    raw += _launch(120, 5, 121, 125)     # the caller, between steps
    s = _summary(raw)
    by = s["by_span"]
    assert s["launches"] == s["device_ops"] == 5
    assert by["decoder.iter"]["count"] == 2
    assert by["decoder.iter"]["host_us"] == pytest.approx(40.0)
    assert [by[n]["self"]["launches"] for n in ("step", "decoder",
                                                "decoder.iter")] == [1, 1, 2]
    assert [by[n]["total"]["launches"] for n in ("step", "decoder",
                                                 "decoder.iter")] == [4, 3, 2]
    assert s["outside"]["launches"] == 1
    # idle gaps: [52, 60] during the second iteration, [80, 121] from the
    # decoder's end of the iteration through the caller's time
    assert s["idle_us"] == pytest.approx(8 + 41)
    assert by["decoder.iter"]["self"]["idle_us"] == pytest.approx(8 + 0)
    assert by["decoder"]["self"]["idle_us"] == pytest.approx(10)
    assert by["step"]["self"]["idle_us"] == pytest.approx(10)
    assert s["outside"]["idle_us"] == pytest.approx(21)
    assert by["step"]["total"]["idle_us"] == pytest.approx(8 + 10 + 10)
    books = spans.accounting(s)
    assert books["launches_gap"] == 0 and books["idle_gap"] < 1e-12
    assert books["launches_in_step"] == pytest.approx(0.8)


def test_a_gap_split_across_two_spans_and_one_outside_every_span():
    raw = [_span("step", 0, 100), _span("render", 10, 40),
           _span("encode", 40, 70), _span("step", 200, 300)]
    raw += _launch(12, 1, 20, 30)
    raw += _launch(65, 2, 60, 90)        # a gap [30, 60]: render, encode
    raw += _launch(205, 3, 210, 220)     # a gap [90, 210]: step, outside
    s = _summary(raw, steps=2)
    by = s["by_span"]
    assert s["idle_us"] == pytest.approx(30 + 120)
    assert by["render"]["self"]["idle_us"] == pytest.approx(10)
    assert by["encode"]["self"]["idle_us"] == pytest.approx(20)
    assert by["step"]["self"]["idle_us"] == pytest.approx(10 + 10)
    assert s["outside"]["idle_us"] == pytest.approx(100)
    assert by["step"]["total"]["idle_us"] == pytest.approx(50)
    m = spans.metrics(s)
    assert m["idle_in_step_pct"] == pytest.approx(100 * 50 / 150)
    assert m["step_dispatch_ms"] == pytest.approx(200e-3 / 2)
    assert m["gru_iter_launches"] is None
    assert spans.accounting(s)["idle_gap"] < 1e-12


def test_launches_of_the_autograd_thread_during_backward():
    raw = [_span("step", 0, 100), _span("backward", 40, 90),
           _span("optimizer", 90, 99)]
    raw += _launch(45, 1, 46, 60, thread=2)
    raw += _launch(50, 2, 60, 70, call="cudaLaunchKernelExC", thread=2)
    raw += _launch(52, 3, 70, 80, call="cuLaunchKernel", thread=2)
    raw += _launch(92, 4, 92, 94)
    s = _summary(raw)
    assert s["by_span"]["backward"]["self"]["launches"] == 3
    assert s["by_span"]["optimizer"]["self"]["launches"] == 1
    assert s["by_span"]["step"]["self"]["launches"] == 0


def test_blocking_calls_and_ops_lost_from_the_device_trace():
    raw = [_span("step", 0, 100), _span("pnp", 60, 100)]
    raw += _launch(61, 1, 62, 70)
    raw += [_Raw("cudaStreamSynchronize", 70, 71),
            _Raw("cudaMemcpy", 72, 73), _Raw("cudaMemcpyAsync", 74, 75),
            _Raw("cudaEventSynchronize", 10, 11),
            _Raw("cudaDeviceSynchronize", 150, 151),
            _Raw("cudaMemsetAsync", 76, 77),
            # a launch whose kernel the device trace lost
            _Raw("cudaLaunchKernelExC", 80, 81)]
    s = _summary(raw)
    by = s["by_span"]
    assert by["pnp"]["self"]["syncs"] == 2
    assert by["step"]["self"]["syncs"] == 1
    assert by["step"]["total"]["syncs"] == 3
    assert s["outside"]["syncs"] == 1 and s["syncs"] == 4
    assert s["launches"] == by["pnp"]["self"]["launches"] == 2
    assert s["device_ops"] == 1 and s["outside"]["launches"] == 0
    assert spans.metrics(s)["host_syncs_per_step"] == 3
    assert spans.accounting(s)["launches_gap"] == 0


def test_table_lists_every_span_and_outside():
    raw = [_span("step", 0, 100)] + _launch(5, 1, 6, 10)
    lines = spans.table(_summary(raw)).splitlines()
    assert lines[1].startswith("step") and lines[-1].startswith("outside")


READERS = [m["name"] for m in spec.manifest()["per_layer"]
           if m["name"].split(".")[0] in spans.METRICS]


def _record(step="eval", trace=None, cell="scflow-ycbv.refine-b32"):
    return {"cell": cell, "step": step, "trace": trace}


def _no_process(*a, **k):
    raise AssertionError("no span trace may be started here")


@pytest.mark.parametrize("metric", READERS)
def test_readers_read_nothing_from_an_untraced_record(metric, monkeypatch):
    monkeypatch.setattr(subprocess, "run", _no_process)
    assert len(READERS) == 10
    read = spec.reader(metric)
    step = "train" if metric.endswith(".train") else "eval"
    assert read(_record(step)) is None
    # outside a run of the record's cell no span trace is taken
    rec = _record(step, trace={})
    assert read(rec) is None and rec["trace"]["spans"] is None


def test_readers_read_a_kept_summary():
    raw = [_span("step", 0, 100), _span("decoder.iter", 10, 30),
           _span("decoder.iter", 40, 60)] + _launch(12, 1, 13, 50)
    rec = _record(trace={"spans": _summary(raw)})
    assert spec.reader("gru_iter_launches.refine")(rec) == 0.5
    assert spec.reader("gru_iter_dispatch_ms.refine")(rec) == pytest.approx(
        0.02)
    assert spec.reader("gru_iter_launches.train")(rec) is None


def test_span_trace_runs_in_a_process_of_its_own(monkeypatch):
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return types.SimpleNamespace(returncode=0, stderr="table\n",
                                     stdout='noise\n{"spans": {"x": 1}}\n')

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(sys, "argv", [
        "portbench/run.py", "--workload", "raft-ycbv.refine-b32", "--seed",
        "4000000019", "--seconds", "40", "--trace", "1"])
    monkeypatch.setitem(sys.modules, "scflow_torch.utils.profiling",
                        types.SimpleNamespace(enable_spans=None))
    rec = _record(trace={}, cell="raft-ycbv.refine-b32")
    assert spans.of(rec) == {"x": 1} and spans.of(rec) == {"x": 1}
    assert len(calls) == 1
    assert calls[0][1:] == [spans.SCRIPT, "--workload",
                            "raft-ycbv.refine-b32", "--seed", "4000000019",
                            "--turns", "0", "--plain", "0"]
    # a port without the switch (as before spans) gets none
    monkeypatch.setitem(sys.modules, "scflow_torch.utils.profiling",
                        types.SimpleNamespace())
    assert spans.of(_record(trace={}, cell="raft-ycbv.refine-b32")) is None
    assert len(calls) == 1
