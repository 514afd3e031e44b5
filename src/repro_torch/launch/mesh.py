"""Device meshes (port of ``repro.launch.mesh``).

One process drives one device.  :func:`make_local_mesh` puts every rank of
the world on ``data`` (the reference's local mesh: ``model`` of size 1 by
default), starting the process group first if none is running: from
``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ...)
or else as a group of one rank; NCCL on ``cuda``, gloo on ``cpu``.
:func:`make_production_mesh` gives the reference's production shapes,
(16, 16) over ``("data", "model")`` or (2, 16, 16) over ``("pod", "data",
"model")``, and builds them only in a world of that many ranks.

Importing this module starts nothing.

Roofline inputs: one NVIDIA H100 SXM5 by NVIDIA's H100 Tensor Core GPU
datasheet (dense rates, no sparsity, at the 700 W limit), and the links
of NVIDIA's DGX H100 system datasheet: 8 cards a node on NVLink 4, each
card with its own ConnectX-7 400 Gb/s InfiniBand port to other nodes.
They are the specification, not measurements.  :func:`axis_link` says
which link a mesh axis's collectives cross.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

# NVIDIA H100 SXM5 datasheet figures, per device
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                  # B/s, HBM3
LINK_BW = 900e9                   # B/s, NVLink 4 (18 links, both directions)
# NVIDIA DGX H100 datasheet: 8 H100 a node; one ConnectX-7 port a card,
# 400 Gb/s InfiniBand NDR = 50 GB/s a direction
CARDS_PER_NODE = 8
INTER_NODE_BW = 50e9              # B/s, a card's InfiniBand port

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _start_process_group(device_type: str) -> None:
    """Start the default process group unless one is running: from
    ``torchrun``'s environment, else one rank in an in-process store."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def local_world() -> int:
    """Ranks of the running group, or of the one ``torchrun`` describes (1
    alone): the data size of :func:`make_local_mesh` with ``model`` 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...],
          device: str | torch.device | None) -> DeviceMesh:
    """A mesh of ``shape`` over ``axes``; raises before it starts anything
    unless the world has exactly that many ranks."""
    dev = resolve_device(device)
    n = 1
    for s in shape:
        n *= s
    if n != local_world():
        raise ValueError(f"a {shape} mesh over {axes} needs {n} ranks; the "
                         f"world has {local_world()}")
    _start_process_group(dev.type)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_local_mesh(model: int = 1,
                    device: str | torch.device | None = None) -> DeviceMesh:
    """Every rank of the world: ``(world // model, model)`` over
    ``("data", "model")``, on ``cuda`` unless ``device="cpu"``."""
    world = local_world()
    if world % model:
        raise ValueError(f"a model axis of {model} does not divide {world} ranks")
    return _mesh((world // model, model), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device | None = None) -> DeviceMesh:
    """The reference's production mesh: 256 ranks as (16, 16), or 512 as
    (2, 16, 16) with ``multi_pod``; raises in a world of another size."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return _mesh(shape, axes, device)


def axis_link(sizes: dict[str, int], axis: str) -> tuple[str, float]:
    """(link name, bytes/s) that mesh axis ``axis``'s collectives cross,
    for a mesh of ``sizes`` (axis name: size, major first) laid out in
    rank order on nodes of CARDS_PER_NODE cards: ``"nvlink"`` where the
    ranks of one group (``size`` of them, ``stride`` apart: the product of
    the minor axes' sizes) lie in one node, else ``"inter-node"``."""
    names = list(sizes)
    stride = 1
    for a in names[names.index(axis) + 1:]:
        stride *= sizes[a]
    if sizes[axis] * stride <= CARDS_PER_NODE:
        return "nvlink", LINK_BW
    return "inter-node", INTER_NODE_BW


def mesh_chips(mesh: DeviceMesh) -> int:
    """Devices in the mesh."""
    return mesh.size()
