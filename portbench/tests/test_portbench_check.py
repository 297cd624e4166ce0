"""The reference against the port at a tiny size on the CPU, and the
harness's verdict with the timed path broken underneath: each fault a
cell can have comes out as not correct. The control (the reference in
TF32 in the program's place) is read on the card."""
import time

import pytest
import torch

from conftest import shrink

from portbench.core import cell, check, spec

REFINE = "scflow-ycbv.refine-b32"
RAFT_REFINE = "raft-ycbv.refine-b32"
TRAINS = ["scflow-ycbv.train-b16", "raft-ycbv.train-b16"]


def _run(name, break_step=None, seed=11):
    rec = cell.run(name, seed, 0.3, False, time.perf_counter(),
                   device="cpu", edit=shrink, break_step=break_step)
    return check.verdict(rec["numbers"], spec.limits(name))


@pytest.mark.parametrize("name", [REFINE, RAFT_REFINE] + TRAINS)
def test_port_agrees_with_reference_on_cpu(name):
    ok, checks = _run(name)
    assert ok, checks
    if name in (REFINE, RAFT_REFINE):
        assert checks["render"]["value"] == 0.0


def _alter_answer(program):
    step = program.step

    def altered(batch):
        out = dict(step(batch))
        t = out["translations"].clone()
        t[0, 0] += 1.0
        out["translations"] = t
        return out

    program.step = altered


def _half_batch_eval(program):
    step = program.step

    def half(batch):
        n = batch["labels"].shape[0] // 2
        out = dict(step({k: v[:n] for k, v in batch.items()}))
        out["rotations"] = torch.cat([out["rotations"],
                                      batch["ref_rotations"][n:]])
        out["translations"] = torch.cat([out["translations"],
                                         batch["ref_translations"][n:]])
        return out

    program.step = half


def _half_batch_train(program):
    step = program.step
    program.step = lambda batch: step(
        {k: v[:batch["labels"].shape[0] // 2] for k, v in batch.items()})


def _state_unchanged(program):
    program.optimizer.step = lambda *a, **k: None


@pytest.mark.parametrize("name", [REFINE, RAFT_REFINE])
@pytest.mark.parametrize("fault", [_alter_answer, _half_batch_eval],
                         ids=["answer_altered", "half_batch"])
def test_refine_faults_are_not_correct(name, fault):
    ok, checks = _run(name, fault)
    assert not ok, checks


def _alter_first_window_step(program):
    """An answer altered in the window's first step alone, so that later
    steps of the same batch answer right."""
    step, calls = program.step, []

    def altered(batch):
        calls.append(None)
        out = step(batch)
        if len(calls) == 1 + WARMUP:
            out = dict(out)
            out["translations"] = out["translations"] + 1.0
        return out

    program.step = altered


WARMUP = 1      # the warm-up steps of ``shrink``


@pytest.mark.parametrize("name", [REFINE, RAFT_REFINE])
def test_a_fault_in_some_steps_is_not_correct(name):
    """A wrong answer in one step of the window fails, where the batch's
    later steps answer right (RAFT: the steps' repeat of their batch's
    last answer)."""
    rec = cell.run(name, 11, 1.0, False, time.perf_counter(), device="cpu",
                   edit=shrink, break_step=_alter_first_window_step)
    assert rec["steps"] > 2      # the altered batch was served again
    ok, checks = check.verdict(rec["numbers"], spec.limits(name))
    assert not ok, checks
    key = "repeat_translation_mm" if name == RAFT_REFINE else \
        "translation_mm"
    assert checks[key]["value"] > 0.5, checks


@pytest.mark.parametrize("name", TRAINS)
@pytest.mark.parametrize("fault", [_half_batch_train, _state_unchanged],
                         ids=["half_batch", "state_unchanged"])
def test_train_faults_are_not_correct(name, fault):
    ok, checks = _run(name, fault)
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", [REFINE, RAFT_REFINE] + TRAINS)
def test_control_is_not_correct(card, name):
    """The reference computed in TF32 in the program's place fails the
    cell's limits, at the cell's sizes with a pool of 3 batches."""
    import sys

    from conftest import ROOT
    sys.path.insert(0, ROOT)
    from portbench.calibrate import control_numbers

    def small(cfg, traffic):
        traffic.update(pool=3, warmup_steps=1)

    for seed in (1, 2, 3):
        rec = cell.run(name, seed, 0.5, False, time.perf_counter(),
                       edit=small, keep=True)
        assert check.verdict(rec["numbers"], spec.limits(name))[0]
        ok, checks = check.verdict(control_numbers(rec, card)["control"],
                                   spec.limits(name))
        assert not ok, checks
