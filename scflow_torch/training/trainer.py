"""The training and evaluation loop (port of
``scflow_tpu/training/trainer.py``): iteration-based training with
periodic logging (JSONL, TensorBoard), image panels, checkpoints and an
optional eval, on one device; batches come from any iterator or
``step -> batch`` callable.

The state is the model and its AdamW optimizer, both changed in place by
the train step; ``Trainer.step`` (the JAX ``TrainState.step``) is the
count of updates AdamW has applied.

Under a process group (``parallel.mesh.initialize_distributed``) the
train step is data-parallel: each process feeds its shard of the global
batch and every process holds the same state. Only rank 0 writes the
checkpoints, the logs and the panels (the JAX package's primary host);
``resume`` reads on every rank, and an ``eval_fn`` runs on every rank.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from collections.abc import Callable, Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..models.refiner import RAFTRefiner, SCFlowRefiner
from ..parallel.mesh import rank
from ..rendering.renderer import Renderer
from .checkpoint import (load_torch_checkpoint, restore_checkpoint,
                         save_checkpoint)
from .config import Config
from .logging import ImageLogger, make_train_panel
from .points_bank import PointsBank
from .steps import (_updates_done, build_model, init_weights, make_eval_step,
                    make_multi_cycle_train_step, make_multi_pass_eval_step,
                    make_optimizer, make_panel_step, make_train_step,
                    onecycle_lr)


def _on_device(x) -> bool:
    return isinstance(x, torch.Tensor) and x.device.type != "cpu"


@dataclasses.dataclass
class Trainer:
    """``cfg`` picks the steps: the multi-cycle train step when
    ``model.train_cycles > 1``, the multi-pass eval step when
    ``model.test_passes > 1``. The model is built on ``device`` with
    ``cfg.seed``'s weights; ``device="cuda"`` raises without a GPU."""
    cfg: Config
    renderer: Renderer
    points_bank: PointsBank
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        cfg = self.cfg
        self.model = build_model(cfg, device=self.device, seed=cfg.seed)
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        if cfg.model.train_cycles > 1:
            self.train_step = make_multi_cycle_train_step(
                self.model, self.renderer, self.points_bank, cfg,
                self.optimizer, cycles=cfg.model.train_cycles,
                device=self.device)
        else:
            self.train_step = make_train_step(
                self.model, self.renderer, self.points_bank, cfg,
                self.optimizer, device=self.device)
        if cfg.model.test_passes > 1:
            self.eval_step = make_multi_pass_eval_step(
                self.model, self.renderer, cfg, passes=cfg.model.test_passes,
                device=self.device)
        else:
            self.eval_step = make_eval_step(self.model, self.renderer, cfg,
                                            device=self.device)
        self._log_file = None
        self._tb_writer = None

    # -- state ------------------------------------------------------------
    @property
    def step(self) -> int:
        """Updates applied so far (read on the host, no device sync)."""
        return _updates_done(self.optimizer)

    def init_state(self, seed: int | None = None) -> None:
        """Fresh weights from ``seed`` (default ``cfg.seed``, the seeded
        init of ``build_model``) and an empty AdamW state: step 0."""
        seed = self.cfg.seed if seed is None else seed
        init_weights(self.model, torch.Generator().manual_seed(seed))
        self.optimizer.state.clear()

    def init_eval_state(self, seed: int | None = None) -> None:
        """:meth:`init_state` for evaluation: the port's init needs no
        sample batch, so the two are the same."""
        self.init_state(seed)

    def load_torch_checkpoint(self, path: str) -> dict:
        """Load a reference torch ``.pth`` into the model (the reference
        ``load_checkpoint=`` eval entry); returns the covered / missing /
        unused report of :func:`checkpoint.load_torch_checkpoint`."""
        return load_torch_checkpoint(path, self.model)

    def resume(self, ckpt_dir: str | None = None,
               step: int | None = None) -> int:
        """Restore the model and AdamW state of checkpoint ``step``
        (default: the newest under ``work_dir/checkpoints``); returns its
        step."""
        ckpt_dir = ckpt_dir or os.path.join(self.cfg.work_dir, "checkpoints")
        return restore_checkpoint(ckpt_dir, self.model, self.optimizer, step)

    # -- logging ----------------------------------------------------------
    @property
    def tb_writer(self):
        """Lazy TensorBoard event writer (None when cfg.tensorboard=False)."""
        if not self.cfg.tensorboard:
            return None
        if self._tb_writer is None:
            from ..utils.tb_writer import TBEventWriter

            self._tb_writer = TBEventWriter(
                os.path.join(self.cfg.work_dir, "tb"))
        return self._tb_writer

    def _log(self, record: dict):
        os.makedirs(self.cfg.work_dir, exist_ok=True)
        if self._log_file is None:
            self._log_file = open(
                os.path.join(self.cfg.work_dir, "train_log.jsonl"), "a")
        self._log_file.write(json.dumps(record) + "\n")
        self._log_file.flush()
        tb = self.tb_writer
        if tb is not None and "step" in record:
            tb.add_scalars({k: v for k, v in record.items()
                            if k != "step" and isinstance(v, (int, float))},
                           int(record["step"]))
            tb.flush()
        msg = " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in record.items())
        print(msg, flush=True)

    def close(self):
        """Close the JSONL log and the TensorBoard writer."""
        for f in (self._log_file, self._tb_writer):
            if f is not None:
                f.close()
        self._log_file = self._tb_writer = None

    # -- training ---------------------------------------------------------
    def fit(self, batch_iterator: Iterator | Callable[[int], dict],
            num_steps: int | None = None,
            eval_every: int | None = None,
            eval_fn: Callable | None = None,
            panel_every: int | None = None) -> None:
        """Train from :attr:`step` to ``num_steps`` (default
        ``optim.total_steps``).

        batch_iterator: an iterator of batch dicts, or a callable
        ``step -> batch``.
        Scalars are read back (a host sync) only on logging steps: the
        first and every ``log_interval``-th.
        eval_every/eval_fn: run ``eval_fn(self) -> dict`` every N steps and
        log the returned scalars under ``eval/``.
        panel_every: write a [real | render | gt/pose/pred flow | mask]
        panel of sample 0 and its per-iteration EPE every N steps
        (SCFlow only). A checkpoint is written every
        ``checkpoint_interval`` steps and at the end.
        """
        num_steps = num_steps or self.cfg.optim.total_steps
        get_batch = (batch_iterator if callable(batch_iterator)
                     else lambda _s, _it=iter(batch_iterator): next(_it))
        ckpt_dir = os.path.join(self.cfg.work_dir, "checkpoints")
        primary = rank() == 0

        panel_step = image_logger = None
        if (primary and panel_every
                and not isinstance(self.model, RAFTRefiner)):
            panel_step = make_panel_step(self.model, self.renderer, self.cfg,
                                         device=self.device)
            image_logger = ImageLogger(self.cfg.work_dir,
                                       tensorboard=self.cfg.tensorboard)
        t_last = time.perf_counter()
        start = self.step
        last_logged = start
        try:
            for step in range(start, num_steps):
                batch = get_batch(step)
                metrics = self.train_step(batch)

                if primary and (step == start
                                or (step + 1) % self.cfg.log_interval == 0):
                    now = time.perf_counter()
                    keys = [k for k, v in metrics.items() if v.ndim == 0]
                    values = torch.stack([metrics[k].float() for k in keys])
                    scalars = dict(zip(keys, values.tolist()))  # one sync
                    scalars.update(step=step + 1,
                                   steps_per_s=(step + 1 - last_logged)
                                   / max(now - t_last, 1e-9),
                                   lr=onecycle_lr(step, self.cfg.optim))
                    self._log(scalars)
                    t_last = now
                    last_logged = step + 1

                if panel_step is not None and (step + 1) % panel_every == 0 \
                        and "gt_rotations" in batch:
                    p = {k: v.float().cpu().numpy()
                         for k, v in panel_step(batch).items()}
                    panel = make_train_panel(
                        p["real"], p["render"], p["gt_flow"], p["pose_flow"],
                        p["pred_flow"], mask=p["mask"],
                        max_flow=self.cfg.model.max_flow)
                    image_logger.log_panel(step + 1, "train_panel", panel)
                    self._log({"step": step + 1,
                               **{f"epe_iter{i}": float(v)
                                  for i, v in enumerate(p["epe_per_iter"])}})

                if primary and (step + 1) % self.cfg.checkpoint_interval == 0:
                    save_checkpoint(ckpt_dir, self.model, self.optimizer,
                                    step + 1)

                if eval_every and eval_fn and (step + 1) % eval_every == 0:
                    eval_metrics = eval_fn(self)
                    if primary:
                        self._log({"step": step + 1,
                                   **{f"eval/{k}": v
                                      for k, v in eval_metrics.items()}})
        finally:
            if image_logger is not None:
                image_logger.close()
        if primary and num_steps > start:
            # a final checkpoint makes short runs resumable
            save_checkpoint(ckpt_dir, self.model, self.optimizer, num_steps)

    # -- evaluation -------------------------------------------------------
    def predict(self, batch: dict, keys: tuple | None = None,
                sync: bool = True) -> dict:
        """Refine one batch and return the outputs named by ``keys``
        (default the poses, and ``pnp_valid`` for RAFT) as numpy arrays;
        the dense outputs stay on the device unless asked for. With
        ``sync=False`` they are returned as device tensors, not copied to
        the host.

        An SCFlow model in bf16 gets float crops cast to bf16 on the host,
        before the upload (half its bytes; its encoder casts them to bf16
        anyway, so the results are the same); uint8 crops go as they are.
        The RAFT family runs in f32 whatever the dtype, so its crops are
        not cast (the JAX package casts them in that config too)."""
        real = batch.get("real_images")
        if (self.cfg.model.dtype == "bfloat16"
                and isinstance(self.model, SCFlowRefiner)
                and real is not None and not _on_device(real)):
            real = torch.as_tensor(real if isinstance(real, torch.Tensor)
                                   else np.asarray(real))
            if real.dtype != torch.uint8:
                batch = dict(batch, real_images=real.to(torch.bfloat16))
        out = self.eval_step(batch)
        if keys is None:
            keys = ("rotations", "translations", "pnp_valid")
        out = {k: v for k, v in out.items() if k in keys}
        if not sync:
            return out
        return {k: v.cpu().numpy() for k, v in out.items()}
