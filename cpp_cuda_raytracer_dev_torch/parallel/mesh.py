"""Process groups and the device mesh for sharded rendering (the JAX
package's ``parallel/mesh.py``), on ``torch.distributed``.

The scaling axes are the JAX package's:

- **rays**: image rows in bands, one band a rank (data parallel over
  pixels; the scene and camera are replicated);
- **prims**: each object's triangle or cluster range split over ranks, the
  per-ray nearest hit min-combined across them (parallel/collectives.py);
- gradients of the replicated scene and camera summed over the rays axis
  (parallel/render_pjit.py `allreduce_gradients`).

The program is SPMD: every rank runs the same entry point with the same
replicated inputs. A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over every rank of the default process group, with the dimension names
``("rays",)`` or ``("rays", "prims")``, PyTorch's counterpart of
``jax.sharding.Mesh``. NCCL serves CUDA ranks (one GPU a rank) and gloo
CPU ranks.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

RAYS_AXIS = "rays"
PRIMS_AXIS = "prims"


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device_type: str = "cuda") -> None:
    """Join the default process group: NCCL for ``device_type`` "cuda"
    (each rank on GPU ``LOCAL_RANK``, or its rank modulo the visible GPUs),
    gloo for "cpu". With no arguments the rendezvous is torchrun's
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``); otherwise ``coordinator`` is "host:port" and every process
    gives the same ``num_processes`` and its own ``process_id``. A CUDA
    group never falls back to gloo: without NCCL it raises."""
    if device_type == "cuda":
        backend = "nccl"
        if not dist.is_nccl_available() or not torch.cuda.is_available():
            raise RuntimeError("device_type='cuda' needs a CUDA device and "
                               "NCCL")
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', not "
                         f"{device_type!r}")
    if coordinator is None:
        kwargs = {}
        rank = int(os.environ.get("RANK", "0"))
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        addr = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        kwargs = dict(init_method=addr, world_size=num_processes,
                      rank=process_id)
        rank = process_id
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, **kwargs)


def make_mesh(n_devices: int | None = None, prims: int = 1,
              device_type: str | None = None, *,
              prims_axis: bool | None = None) -> DeviceMesh:
    """A ("rays",) or ("rays", "prims") mesh over every rank.

    As in the JAX package the mesh is 2-D when ``prims`` > 1; with
    ``prims_axis=True`` it is 2-D at any ``prims`` (a (n, 1) mesh), which
    one process uses to drive the 2-D entry points. ``n_devices`` must be
    the world size: an SPMD program runs on every rank of its group.
    ``device_type`` defaults to that of the default group's backend
    ("cuda" for NCCL, "cpu" for gloo)."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"the mesh spans every rank: n_devices={n}, world "
                         f"size {world}")
    if n % prims:
        raise ValueError(f"{n} devices not divisible by prims={prims}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if prims_axis or (prims_axis is None and prims > 1):
        return init_device_mesh(device_type, (n // prims, prims),
                                mesh_dim_names=(RAYS_AXIS, PRIMS_AXIS))
    if prims != 1:
        raise ValueError("prims_axis=False needs prims=1")
    return init_device_mesh(device_type, (n,), mesh_dim_names=(RAYS_AXIS,))


def check_mesh(mesh) -> DeviceMesh:
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh (parallel/mesh.py "
                        f"make_mesh), not {type(mesh).__name__}")
    if mesh.mesh_dim_names is None or RAYS_AXIS not in mesh.mesh_dim_names:
        raise ValueError(f"the mesh needs a {RAYS_AXIS!r} dimension, has "
                         f"{mesh.mesh_dim_names}")
    return mesh


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Ranks along ``axis``; 1 for "prims" on a rays-only mesh."""
    if axis not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``jax.lax.axis_index``)."""
    if axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of this rank's line along ``axis``, or None for
    "prims" on a rays-only mesh."""
    if axis not in mesh.mesh_dim_names:
        return None
    return mesh.get_group(axis)


def ray_band(mesh: DeviceMesh, res_h: int) -> tuple[int, int]:
    """This rank's band of image rows, (row0, band_h): the object form of
    the JAX package's ``ray_sharding`` (rows sharded over "rays")."""
    n = axis_size(mesh, RAYS_AXIS)
    if res_h % n:
        raise ValueError(f"res_h={res_h} must divide over {n} devices")
    band_h = res_h // n
    return axis_index(mesh, RAYS_AXIS) * band_h, band_h


def ray_sharding(mesh: DeviceMesh) -> list:
    """DTensor placements of a per-ray array (rows sharded over "rays",
    replicated over "prims"): the JAX package's ``P("rays")``."""
    return [Shard(0)] + [Replicate()] * (mesh.ndim - 1)


def replicated(mesh: DeviceMesh) -> list:
    """DTensor placements of a replicated array: the JAX ``P()``."""
    return [Replicate()] * mesh.ndim
