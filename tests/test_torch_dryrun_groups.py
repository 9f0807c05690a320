"""The dry run of a layer in gcd head groups across restarts of the fake
process group (a file of its own: it restarts the group, which the other
dry-run files hold in module fixtures)."""
import dataclasses
import math

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib


def test_head_groups_across_group_restarts():
    """A layer in gcd head groups (6 / 6 heads on a 4-way model axis: 2
    groups of 3) on a 1x4 mesh, then a 2x4 mesh, then the 1x4 mesh again,
    the fake group restarted each time as the CLI restarts it between the
    single- and multi-pod meshes: every run completes, and the repeat
    counts the same bytes as the first (the split mesh of the groups is
    rebuilt in each process group)."""
    import torch.distributed as dist

    cfg = dataclasses.replace(configs.get("minicpm-2b").smoke, d_model=1536,
                              d_ff=2048, vocab_size=4096, num_heads=6,
                              num_kv_heads=6, head_dim=256)
    shape = configs.ShapeConfig("prefill_s", 32, 4, "prefill")
    temps = []
    try:
        for mesh_shape in ((1, 4), (2, 4), (1, 4)):
            mesh_lib.start_fake_group(math.prod(mesh_shape))
            mesh = mesh_lib.make_mesh(mesh_shape, ("data", "model"), "cpu")
            rec = dryrun.run_cell("minicpm-2b", shape, mesh=mesh, cfg=cfg,
                                  roofline=False)
            temps.append(rec["memory"]["temp_bytes"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert temps[0] == temps[2] and temps[1] < temps[0], temps
