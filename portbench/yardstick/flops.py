"""The step's floating-point operations, counted by ``FlopCounterMode``
on the plain reference with meta tensors at the cell's sizes (so the
count is the same whatever implements the step), and the instance-norm
planes its encoders normalise."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import steps
from ..reference.models.layers import FusedInstanceNorm


def count_step(cfg: dict, traffic: dict) -> dict:
    """{flops: per step, norm_shapes: [(N, C, H, W)] of every instance
    norm a step runs forward, backward: whether each also runs back}."""
    h, w = cfg["image_size"]
    n, m = traffic["batch"], cfg["model"]
    train = traffic["step"] == "train"
    model = steps.build_model(m, (h, w), "meta")
    shapes = []
    for mod in model.modules():
        if isinstance(mod, FusedInstanceNorm):
            mod.register_forward_pre_hook(
                lambda _, args: shapes.append(tuple(args[0].shape)))

    def meta(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    eye = torch.eye(3, device="meta").expand(n, 3, 3)
    batch = {"real_images": meta(n, h, w, 3, dtype=torch.uint8),
             "ref_rotations": eye, "gt_rotations": eye,
             "ref_translations": meta(n, 3), "gt_translations": meta(n, 3),
             "k": eye, "labels": meta(n, dtype=torch.long),
             "gt_masks": meta(n, h, w)}
    c, p = m["num_class"], cfg["loss"]["num_loss_points"]
    points = {"points": meta(c, p, 3),
              "valid": meta(c, p, dtype=torch.bool),
              "symmetric": meta(c, dtype=torch.bool),
              "diameters": meta(c)}
    rendered, depth, rmask = meta(n, h, w, 3), meta(n, h, w), meta(n, h, w)
    with FlopCounterMode(display=False) as counter:
        if train:
            steps.loss_of_render(model, rendered, depth, rmask, points,
                                 batch, cfg).backward()
        else:
            with torch.no_grad():
                real = rendered
                if isinstance(model, steps.RAFTRefiner):
                    model(rendered, real, iters=m["test_iters"])
                else:
                    model(rendered, real, batch["ref_rotations"],
                          batch["ref_translations"], depth, batch["k"],
                          batch["labels"], iters=m["test_iters"],
                          lowres=m["lowres_eval"])
    return {"flops": counter.get_total_flops(), "norm_shapes": shapes,
            "backward": train}
