"""Device meshes: the production shapes (single-pod 16×16, 2-pod
2×16×16) and the mesh of the running process group.

Port of ``repro.launch.mesh``.  A mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` over the default
process group, one process a rank, with the JAX mesh's axis names.  The
production shapes and names are kept because the rule table
(:mod:`repro_torch.launch.sharding`) and its tests are stated for them;
they are built only when the default group has their world size, which
the dry run's fake group (:mod:`repro_torch.launch.dryrun`) has.

The roofline's hardware constants are the H100 SXM data sheet's (NVIDIA
H100 80GB HBM3 at 700 W), per card.
"""
from __future__ import annotations

import socket

import torch
import torch.distributed as dist

from repro_torch import resolve_device

# NVIDIA H100 80GB HBM3 (SXM5, 700 W) data sheet, per card
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12                # B/s
HBM_BYTES = 80e9                # B of device memory
NVLINK_BW = 450e9               # B/s a direction (NVLink 4, 18 links)

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """The production mesh over the default group, which must have its
    world size (256, or 512 with ``multi_pod``): in practice the dry
    run's fake group.  Raises otherwise."""
    shape, names = PRODUCTION_SHAPES[multi_pod]
    want = 1
    for n in shape:
        want *= n
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != want:
        raise RuntimeError(
            f"make_production_mesh: the {shape} mesh needs a default group "
            f"of {want} ranks, the running one has {have} (the dry run "
            f"builds a fake group of that size)")
    return _mesh(device_type, shape, names)


def free_port() -> int:
    """A free TCP port on localhost, for a group's ``tcp://`` address."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_host_mesh(device="cuda"):
    """``(world, 1)`` ``("data", "model")`` over the running group.

    Without a running group this process starts one of a single rank:
    ``nccl`` for a card (raises without one), ``gloo`` for
    ``device="cpu"``.  Launched with ``torchrun`` the group is the
    launcher's."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{free_port()}",
            rank=0, world_size=1)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return _mesh(dev.type, (dist.get_world_size(), 1), ("data", "model"))
