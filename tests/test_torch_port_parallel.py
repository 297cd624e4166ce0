"""Multi-process runs of the PyTorch port on the CPU: 2 gloo ranks spawned
by ``scflow_torch.parallel.mesh.spawn`` (each on a free port) against
one process, and the data-parallel train step against JAX's own gap
between its 1-device and 2-device steps on the same batch (checked in as
``JAX_DP_GAP``; running this file as a script measures it again).

The rank functions live in ``torch_parallel_ranks.py`` (importable by
name in a spawned process, no JAX).
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks

EVAL_ARGS = (3, 64, 2, 4)        # classes, crop, iterations, slot budget


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from scflow_torch.tools.make_synthetic_bop import main

    out = tmp_path_factory.mktemp("bop")
    main(["--out", str(out), "--num-images", "6", "--num-classes", "3",
          "--height", "160", "--width", "160", "--min-objects", "1",
          "--max-objects", "3", "--seed", "2", "--device", "cpu"])
    return str(out)


@pytest.fixture(scope="module")
def train_tree(tmp_path_factory):
    """A 3-class ``train_real`` split of 8 images for the training CLI."""
    from scflow_torch.tools.make_synthetic_bop import main

    out = tmp_path_factory.mktemp("trainbop")
    main(["--out", str(out), "--split", "train_real", "--num-images", "8",
          "--num-classes", "3", "--height", "128", "--width", "160",
          "--seed", "5", "--device", "cpu"])
    return str(out)


@pytest.fixture(scope="module")
def two_ranks(tree, train_tree, tmp_path_factory):
    """Every rank check (``torch_parallel_ranks.checks``) over 2 spawned
    gloo ranks, in one spawn: the results by rank."""
    from scflow_torch.parallel.mesh import spawn

    work = tmp_path_factory.mktemp("train_cli")
    with ranks.one_thread_each():
        results = spawn(ranks.checks, 2, (4, (tree, *EVAL_ARGS), str(work),
                                          train_tree))
    return results, work


def test_collectives_over_two_ranks(two_ranks):
    """reduce_metrics sums every dtype, allgather_results concatenates in
    rank order, and MetricAccumulator states merged by reduce_metrics give
    the metric of one process fed every instance; both ranks agree."""
    from scflow_torch.parallel import MetricAccumulator

    got = [r["collectives"] for r in two_ranks[0]]
    acc = MetricAccumulator(num_classes=5)
    state = acc.init("cpu")
    acc.update(state, *(torch.from_numpy(a)
                        for a in ranks.accumulator_inputs(4)))
    want = acc.compute(state)
    for g in got:
        np.testing.assert_array_equal(g["sums"]["int"], [0, 3, 6])
        np.testing.assert_array_equal(g["sums"]["float"], np.full((2, 2), 0.75))
        assert g["sums"]["scalar"] == 1.0
        np.testing.assert_array_equal(g["gathered"]["ids"], [0, 10, 11])
        np.testing.assert_array_equal(g["gathered"]["rows"],
                                      [[0, 0], [1, 1], [1, 1]])
        assert g["metric"] == want
    assert want["num_instances"] > 20


def test_single_process_collectives_are_identities():
    """Without a process group: the rank is 0 of 1, shard_batch and the
    collectives return their input, and initialize_distributed with
    neither a count nor SCFLOW_NUM_PROCESSES starts nothing."""
    from scflow_torch.parallel import (allgather_results,
                                       initialize_distributed, rank,
                                       reduce_metrics, shard_batch,
                                       world_size)

    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("SCFLOW_NUM_PROCESSES", raising=False)
        assert initialize_distributed(device="cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert (rank(), world_size()) == (0, 1)
    tree = {"a": torch.ones(3)}
    assert reduce_metrics(tree) is tree
    arrays = {"b": np.arange(3)}
    assert allgather_results(arrays) is arrays
    batch = {"x": np.arange(4)}
    assert shard_batch(batch) is batch


def test_update_makes_no_tensor_from_host_values():
    """MetricAccumulator.update copies nothing from the host (on the card
    such a copy waits for every queued kernel): with torch.tensor,
    as_tensor and new_tensor refusing host values, its state equals an
    update run without the guard."""
    from scflow_torch.parallel import MetricAccumulator

    acc = MetricAccumulator(num_classes=5)
    inputs = [torch.from_numpy(a) for a in ranks.accumulator_inputs(1)]
    want = acc.update(acc.init("cpu"), *inputs)
    state = acc.init("cpu")
    with _no_host_tensors():
        acc.update(state, *inputs)
        acc.update(state, *inputs[:3])          # valid=None
    acc.update(want, *inputs[:3])
    for k in want:
        assert torch.equal(state[k], want[k]), k
    assert int(state["under_threshold"].sum()) > 0


@contextlib.contextmanager
def _no_host_tensors():
    def refuse(*args, **kw):
        raise AssertionError("a tensor made from host values")

    real_as_tensor = torch.as_tensor

    def as_tensor(data, *args, **kw):
        if not isinstance(data, torch.Tensor):
            refuse()
        return real_as_tensor(data, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "tensor", refuse)
        mp.setattr(torch.Tensor, "new_tensor", refuse)
        mp.setattr(torch, "as_tensor", as_tensor)
        yield


def _assert_metrics_match(got: dict, want: dict, atol: float) -> None:
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, int):
            assert got[k] == v, k
        else:
            assert abs(got[k] - v) <= atol, (k, got[k], v)


def test_evaluate_dataset_over_two_ranks(tree, two_ranks):
    """evaluate_dataset with a pose-graph metric over 2 ranks (images
    rank::2, both metrics' records gathered): every rank's metric dicts
    match the 1-process ones and the ranks' results split the images.

    Counts and keys are equal; values within 1e-5: the CPU's convolutions
    are not bit-reproducible across processes at 4 threads (two 1-process
    runs at 4 threads each differ by 1.2e-7 in a rotation), and the AUCs
    move with the errors."""
    want, want_pg, want_results = ranks.evaluate_tree(tree, *EVAL_ARGS)
    got = [r["evaluate"] for r in two_ranks[0]]
    for metrics, pg, _ in got:
        _assert_metrics_match(metrics, want, atol=1e-5)
        _assert_metrics_match(pg, want_pg, atol=1e-5)
    ids = [[r["img_id"] for r in g[2]] for g in got]
    assert ids == [[0, 2, 4], [1, 3, 5]]
    for rank_results in (got[0][2], got[1][2]):
        for r in rank_results:
            w = want_results[r["img_id"]]
            np.testing.assert_allclose(r["rotations"], w["rotations"],
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(r["translations"], w["translations"],
                                       atol=1e-4, rtol=1e-5)
    assert want["num_instances"] == sum(len(r["labels"]) for r in want_results)
    assert want_pg["num_instances"] == want["num_instances"]
    assert want_pg != want          # the pose graph moved some pose


@pytest.fixture(scope="module")
def dp_steps(two_ranks):
    """The train step on the whole batch in this process, and on its two
    halves over 2 ranks."""
    return ranks.train_step(), [r["train_step"] for r in two_ranks[0]]


def _flat(tree: dict, keys) -> np.ndarray:
    return np.concatenate([np.asarray(tree[k]).ravel() for k in keys])


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# JAX's gap between its 1-device and 2-device gradients on
# ``ranks.train_batch`` (jax 0.9.0 on the CPU), checked in because its two
# compiles take ~25 s; it comes from
#   JAX_PLATFORMS=cpu python tests/test_torch_port_parallel.py
JAX_DP_GAP = 0.003020632779225707


def jax_dp_gap() -> float:
    """JAX's relative gradient gap between its 1-device step and its
    2-device step (the batch sharded over 2 of the 8 virtual CPU devices)
    on the same batch and weights: ``scflow_loss``'s gradient in train
    mode, the port's render at the reference pose as input."""
    from flax.traverse_util import flatten_dict
    from scflow_torch.training.steps import normalization, render_at_pose
    from scflow_torch.weights import to_jax_variables
    from scflow_tpu.parallel import make_mesh, shard_batch
    from scflow_tpu.rendering import make_test_meshes
    from scflow_tpu.training import (Config, LossConfig, ModelConfig,
                                     build_model, build_points_bank,
                                     scflow_loss)

    model, cfg, renderer, _, _ = ranks.train_setup()
    batch = ranks.train_batch(renderer)
    images, depth, mask = render_at_pose(
        renderer, batch["ref_rotations"], batch["ref_translations"],
        batch["k"], batch["labels"].long(), *normalization(cfg, "cpu"))
    batch = {k: v.numpy() for k, v in dict(
        batch, rendered_images=images, rendered_depths=depth,
        rendered_masks=mask).items()}
    batch["labels"] = batch["labels"].astype(np.int32)
    variables = to_jax_variables(model)
    jcfg = Config(model=ModelConfig(num_class=ranks.TRAIN_CLASSES,
                                    iters=ranks.TRAIN_ITERS,
                                    test_iters=ranks.TRAIN_ITERS),
                  loss=LossConfig(num_loss_points=64))
    jmodel = build_model(jcfg)
    points = build_points_bank(
        make_test_meshes(num_classes=ranks.TRAIN_CLASSES, subdivisions=1,
                         radius=60.0), symmetric_classes=(1,), num_points=64)
    grad_fn = jax.jit(jax.grad(
        lambda p, s, b: scflow_loss(p, s, b, model=jmodel, points_bank=points,
                                    cfg=jcfg, train=True)[0]))
    one = grad_fn(variables["params"], variables["batch_stats"], batch)
    two = grad_fn(variables["params"], variables["batch_stats"],
                  shard_batch(batch, make_mesh(jax.devices()[:2])))
    one, two = (flatten_dict(jax.tree.map(np.asarray, g), sep="/")
                for g in (one, two))
    keys = sorted(one)
    return _rel(_flat(two, keys), _flat(one, keys))


def test_dp_train_step_matches_one_process(dp_steps):
    """2 ranks × 2 samples (4 classes, 64², the last slot masked by
    sample_valid) against 1 process × 4: the loss terms and the BN running
    statistics within 1e-5 relative, the gradient (summed over the ranks
    before the clip) within max(1e-3, 5 × JAX's own 1-vs-2-device gap) of
    its norm (the rule of test_torch_port_train.py), and both ranks hold
    bit-equal metrics and parameters after the update."""
    one, two = dp_steps
    for rank_out in two:
        for key in ("loss", "loss_pose", "loss_flow", "loss_mask",
                    "seq_pose_loss", "seq_flow_loss", "seq_mask_loss",
                    "grad_norm"):
            np.testing.assert_allclose(rank_out["metrics"][key],
                                       one["metrics"][key], rtol=1e-5,
                                       err_msg=key)
        for k, v in one["stats"].items():
            np.testing.assert_allclose(rank_out["stats"][k], v, rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    keys = sorted(one["grads"])
    gap = _rel(_flat(two[0]["grads"], keys), _flat(one["grads"], keys))
    print(f"DP gradient: 2 ranks vs 1 process {gap:.2e}; JAX 2 vs 1 "
          f"device {JAX_DP_GAP:.2e}")
    assert gap <= max(1e-3, 5 * JAX_DP_GAP)
    for k in two[0]["metrics"]:
        np.testing.assert_array_equal(two[0]["metrics"][k],
                                      two[1]["metrics"][k])
    for k in one["params"]:
        np.testing.assert_array_equal(two[0]["params"][k],
                                      two[1]["params"][k])
    moved = _rel(_flat(two[0]["params"], keys), _flat(one["params"], keys))
    assert moved < 1e-3


def test_train_cli_over_two_ranks(two_ranks):
    """The training CLI (synthetic, panels and the on-device eval) over 2
    ranks: rank 0 alone writes the log, the panels, the TB events and the
    checkpoint; both ranks end at step 2 with equal parameters."""
    results, work = two_ranks
    (files0, total0, step0), (files1, total1, step1) = (
        r["train_cli"] for r in results)
    assert files1 == []
    assert "train_log.jsonl" in files0
    assert any(f.startswith("checkpoints/") for f in files0)
    assert any(f.startswith("images/") for f in files0)
    assert (step0, step1) == (2, 2) and total0 == total1
    log = (work / "rank0" / "train_log.jsonl").read_text()
    assert "eval/average/add_0.10d" in log


def test_train_cli_from_disk_over_two_ranks(two_ranks):
    """The training CLI on a BOP ``train_real`` split over 2 ranks: each
    rank builds only its half of the global batch of 4, from its own
    stream (the ranks' batches differ), and both end at step 2 with equal
    parameters; rank 1 writes nothing."""
    results, work = two_ranks
    (seen0, total0, step0), (seen1, total1, step1) = (
        r["train_cli_disk"] for r in results)
    assert [n for n, _ in seen0] == [n for n, _ in seen1] == [2, 2]
    assert all(a != b for (_, a), (_, b) in zip(seen0, seen1))
    assert (step0, step1) == (2, 2) and total0 == total1
    assert not any((work / "disk1").rglob("*.*"))
    assert (work / "disk0" / "train_log.jsonl").exists()


def test_dryrun_multichip_two_ranks(capsys):
    """The twin of ``__graft_entry__.dryrun_multichip`` over 2 gloo ranks:
    a finite loss that both ranks agree on."""
    from scflow_torch.graft_entry import dryrun_multichip

    with ranks.one_thread_each():
        loss = dryrun_multichip(2, device="cpu")
    assert np.isfinite(loss)
    assert "dryrun_multichip(2): ok" in capsys.readouterr().out


def test_initialize_distributed_reads_the_environment(monkeypatch):
    """SCFLOW_NUM_PROCESSES/_PROCESS_ID/_COORDINATOR reach the gloo group
    on the CPU (its start is recorded, not made: a rank of 2 would wait
    for the other); a count of 1, as in JAX, starts nothing."""
    from scflow_torch.parallel import initialize_distributed

    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setenv("SCFLOW_NUM_PROCESSES", "1")
    assert initialize_distributed(device="cpu") == torch.device("cpu")
    assert calls == []
    monkeypatch.setenv("SCFLOW_NUM_PROCESSES", "2")
    monkeypatch.setenv("SCFLOW_PROCESS_ID", "1")
    monkeypatch.delenv("SCFLOW_COORDINATOR", raising=False)
    assert initialize_distributed(device="cpu") == torch.device("cpu")
    monkeypatch.setenv("SCFLOW_COORDINATOR", "127.0.0.1:29611")
    initialize_distributed(device="cpu")
    assert calls == [(("gloo",), dict(init_method=f"tcp://{address}",
                                      world_size=2, rank=1))
                     for address in ("127.0.0.1:9999", "127.0.0.1:29611")]
    assert not torch.distributed.is_initialized()


if __name__ == "__main__":
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_force_host_platform_device_count=8")
    print(f"JAX_DP_GAP = {jax_dp_gap()!r}")
