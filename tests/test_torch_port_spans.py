"""The port's spans (``utils.profiling.span``), on the CPU: off, ``span``
is one shared no-op context that records nothing; on, spans nest and
appear by name in a ``torch.profiler`` trace around the step's ops; the
eval steps (SCFlow, RAFT with its PnP) and the train steps give the same
outputs, losses and parameters, bit for bit, with spans on and off, and
open the spans README lists, each GRU iteration once (also where the
iteration is recomputed in the backward pass)."""
import copy

import pytest
import torch

from scflow_torch.utils import profiling
from scflow_torch.utils.profiling import (SPAN_PREFIX, enable_spans, span,
                                          spans_enabled)

ITERS = 2


def _profiled(fn):
    """(fn's result, the names of the trace's spans in order of start)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = [e.name[len(SPAN_PREFIX):] for e in sorted(
        prof.events(), key=lambda e: e.time_range.start)
        if e.name.startswith(SPAN_PREFIX)]
    return out, names, prof


def test_spans_off_are_one_noop_that_records_nothing():
    assert not profiling._spans_on
    a, b = span("step"), span("decoder.iter")
    assert a is b
    with a as entered:
        assert entered is None

    def run():
        with span("step"), span("inner"):
            return torch.ones(4, 4) @ torch.ones(4, 4)

    out, names, prof = _profiled(run)
    assert names == []
    assert not [e for e in prof.events() if e.is_user_annotation]
    assert torch.equal(out, torch.full((4, 4), 4.0))


def test_spans_on_nest_around_the_ops_by_name():
    assert enable_spans(True) is False
    try:
        assert span("x") is not span("x")

        def run():
            with span("step"):
                with span("inner"):
                    torch.ones(4, 4) @ torch.ones(4, 4)
                torch.ones(3).sum()

        _, names, prof = _profiled(run)
    finally:
        assert enable_spans(False) is True
    assert names == ["step", "inner"]
    events = {e.name: e for e in prof.events()}
    step, inner = events[SPAN_PREFIX + "step"], events[SPAN_PREFIX + "inner"]
    mm = next(e for e in prof.events() if e.name == "aten::mm")
    for outer, e in ((step, inner), (inner, mm)):
        assert outer.time_range.start <= e.time_range.start
        assert e.time_range.end <= outer.time_range.end
    with spans_enabled():
        assert profiling._spans_on
        with spans_enabled(False):
            assert span("a") is span("b")
        assert profiling._spans_on
    assert not profiling._spans_on


def test_spans_are_switched_back_after_an_error():
    with pytest.raises(ValueError):
        with spans_enabled():
            raise ValueError("inside")
    assert span("a") is span("b")


@pytest.fixture(scope="module")
def parts():
    from scflow_torch.rendering import Renderer, make_test_meshes
    from scflow_torch.training import build_points_bank

    bank = make_test_meshes(2, subdivisions=1, device="cpu")
    renderer = Renderer(bank, image_size=(64, 64))
    points = build_points_bank(bank, symmetric_classes=(1,), num_points=16)
    return renderer, points


def _batch(renderer, seed: int) -> dict:
    from scflow_torch.data import synthetic_batch

    return synthetic_batch(torch.Generator().manual_seed(seed), renderer, 2)


def _config(family: str, remat: bool = False):
    from scflow_torch.training import Config, ModelConfig, RenderConfig

    return Config(model=ModelConfig(family=family, num_class=2, iters=ITERS,
                                    test_iters=ITERS, remat=remat),
                  render=RenderConfig(image_size=(64, 64)))


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    else:
        assert torch.equal(a, b)


EVAL_SPANS = {"step": 1, "inputs": 1, "render": 1, "encode": 1,
              "decoder": 1, "decoder.iter": ITERS}


@pytest.mark.parametrize("family", ["scflow", "raft_flow_mask"])
def test_eval_step_same_with_spans_on_and_off(parts, family):
    from scflow_torch.training import build_model, make_eval_step

    renderer, _ = parts
    cfg = _config(family)
    step = make_eval_step(build_model(cfg, device="cpu"), renderer, cfg,
                          device="cpu")
    batch = _batch(renderer, 3)
    off, names_off, _ = _profiled(lambda: step(batch))
    with spans_enabled():
        on, names, _ = _profiled(lambda: step(batch))
    _assert_same(off, on)
    assert names_off == []
    want = dict(EVAL_SPANS, **({"pnp": 1} if family != "scflow" else {}))
    assert {n: names.count(n) for n in set(names)} == want
    assert names[0] == "step"


@pytest.mark.parametrize("family,remat", [("scflow", False), ("scflow", True),
                                          ("raft_flow_mask", False)])
def test_train_step_same_with_spans_on_and_off(parts, family, remat):
    from scflow_torch.training import (build_model, make_optimizer,
                                       make_train_step)

    renderer, points = parts
    cfg = _config(family, remat)
    model = build_model(cfg, device="cpu")
    twin = copy.deepcopy(model)
    steps = [make_train_step(m, renderer, points, cfg,
                             make_optimizer(cfg, m.parameters()),
                             device="cpu") for m in (model, twin)]
    batch = _batch(renderer, 4)
    off, names_off, _ = _profiled(lambda: steps[0](batch))
    with spans_enabled():
        on, names, _ = _profiled(lambda: steps[1](batch))
    _assert_same(off, on)
    _assert_same(dict(model.named_parameters()),
                 dict(twin.named_parameters()))
    assert names_off == []
    # the iteration spans sit at the loop's call site: a remat recompute
    # in the backward pass opens none
    assert {n: names.count(n) for n in set(names)} == {
        "step": 1, "inputs": 2, "render": 1, "encode": 1, "decoder": 1,
        "decoder.iter": ITERS, "backward": 1, "optimizer": 1}


def test_trace_turns_spans_on_inside_its_block(parts, tmp_path):
    import json

    from scflow_torch.training import build_model, make_eval_step

    renderer, _ = parts
    cfg = _config("scflow")
    step = make_eval_step(build_model(cfg, device="cpu"), renderer, cfg,
                          device="cpu")
    with profiling.trace(str(tmp_path)):
        assert profiling._spans_on
        step(_batch(renderer, 5))
    assert not profiling._spans_on
    (path,) = tmp_path.glob("trace_*.json")
    names = [e.get("name", "") for e in json.loads(
        path.read_text())["traceEvents"]]
    for n in EVAL_SPANS:
        assert SPAN_PREFIX + n in names
    assert names.count(SPAN_PREFIX + "decoder.iter") == ITERS


def test_profile_dir_traces_the_three_batches_after_the_first(tmp_path):
    """``python -m scflow_torch.test --profile-dir DIR``'s loop: the
    batches after the first are consumed with spans on, inside one trace
    written to DIR; without a directory the batches pass untouched."""
    from scflow_torch.training.evaluate import PROFILED_BATCHES, _profiled

    seen = [(i, profiling._spans_on) for i in _profiled(
        range(6), str(tmp_path), torch.device("cpu"))]
    assert PROFILED_BATCHES == 3
    assert seen == [(0, False), (1, True), (2, True), (3, True), (4, False),
                    (5, False)]
    assert len(list(tmp_path.glob("trace_*.json"))) == 1
    assert list(_profiled(iter(range(3)), None, torch.device("cpu"))) == [
        0, 1, 2]
