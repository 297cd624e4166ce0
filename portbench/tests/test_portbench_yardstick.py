"""The benchmark's frozen work formulas and peaks equal the port's own
today, at the cells' shapes."""
import pytest
import torch

from scflow_torch.ops import fused_norm, rasterize_fast
from scflow_torch.utils import profiling

from portbench.core import inputs, spec
from portbench.yardstick import flops, peaks, work

MAN = spec.manifest()


def test_peaks_equal_the_ports():
    for card, p in peaks.PEAKS.items():
        assert p == profiling.PEAKS[card]


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_norm_work_equals_the_ports(cell):
    cfg = spec.config(MAN, cell["config"])
    counted = flops.count_step(cfg, spec.traffic(cell["traffic"]))
    assert len(counted["norm_shapes"]) == 30
    for shape in set(counted["norm_shapes"]):
        x = torch.empty(shape, device="meta")
        assert work.norm_work(shape, 4, False) == fused_norm.fwd_work(x)
        assert work.norm_work(shape, 4, True) == fused_norm.bwd_work(x)


def test_tile_pass_work_equals_the_ports():
    cell = MAN["workloads"][0]
    cfg, traffic = spec.config(MAN, cell["config"]), spec.traffic(
        cell["traffic"])
    cfg["model"]["num_class"] = 3
    traffic.update(batch=2, pool=1)
    dev = torch.device("cpu")
    meshes = inputs.make_meshes(cfg, 7, dev)
    tables = inputs.mesh_tables(meshes)
    batch = inputs.make_pool(cfg, traffic, tables, 7, dev)[0]
    from portbench.reference.geometry.se3 import matvec3
    from portbench.reference.ops import tile_pass

    labels = batch["labels"]
    tri_cam = (matvec3(batch["ref_rotations"][:, None, None],
                       tables.tri_pos[labels])
               + batch["ref_translations"][:, None, None, :])
    uvw = matvec3(batch["k"][:, None, None], tri_cam)
    tri_xy = uvw[..., :2] / (uvw[..., 2:] + 1e-8)
    valid = torch.ones(tri_xy.shape[:2], dtype=torch.bool)
    args = (tri_xy, uvw[..., 2], valid, 256, 256, tables.tri_attr[labels])
    ours = tile_pass.tile_inputs(*args)
    theirs = rasterize_fast.tile_inputs(*args)
    for a, b in zip(ours[:3], theirs[:3]):
        assert torch.equal(a, b)
    mine = work.tile_pass_work(ours[0], ours[1], 256, 256, ours[3], ours[4])
    assert mine == rasterize_fast.tile_pass_work(theirs[0], theirs[1], 256,
                                                 256, theirs[3], theirs[4])
    assert mine[0] > 0


def test_refine_flops_match_the_published_count():
    cell = MAN["workloads"][0]
    counted = flops.count_step(spec.config(MAN, cell["config"]),
                               spec.traffic(cell["traffic"]))
    # 2.53 TFLOP a step at batch 32 (the port's profile_roofline)
    assert 2.50e12 < counted["flops"] < 2.56e12
