"""Device meshes on ``torch.distributed`` (the port of
``repro.launch.mesh``).

A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` over the
ranks of the default process group, one rank a device (torchrun's
layout).  Every function here is a function, never a module-level
constant, so importing this module touches no process group.

:func:`make_combining_mesh` is the combining tier's 1-D ``("shard",)``
mesh (DESIGN.md §18).  With no process group initialized, the world is
this one process: the function then starts a one-rank group itself, over
a ``FileStore`` in a fresh temporary directory — no TCP port, so two
processes side by side (test workers) never collide.  The backend follows
the device: NCCL for CUDA, gloo for the CPU.

:func:`make_production_mesh`, :func:`make_mesh_for_world` and
:func:`mesh_axes` lay out the (pod, data, model) meshes of the sharded
steps (``launch/steps.py``), the trainer (``launch/train.py``) and the
dry run (``launch/dryrun.py``).
"""
from __future__ import annotations

import math
import os
import tempfile
from typing import Optional, Sequence, Tuple


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _device_type(device) -> str:
    from ..core.batched_pq import resolve_device

    return resolve_device(device).type


def _ensure_world(device=None) -> int:
    """The default process group, started as a one-rank group over a
    ``FileStore`` in a temporary directory when none is initialized.
    Returns the world size."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dev_type = _device_type(device)
        path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_mesh_"),
                            "store")
        dist.init_process_group(_backend(dev_type),
                                store=dist.FileStore(path, 1), rank=0,
                                world_size=1)
    return dist.get_world_size()


def _mesh(device_type: str, ranks, names):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16×16 single-pod (256 ranks) or 2×16×16 multi-pod (512 ranks)."""
    import torch

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev_type = _device_type(device)
    _ensure_world(device)
    return _mesh(dev_type, torch.arange(math.prod(shape)).reshape(shape),
                 axes)


def make_mesh_for_world(n_devices: int, *, model_parallel: int = 1,
                        pods: int = 1, device=None):
    """Elastic-scaling helper: a (pods,) data × model mesh over the first
    ``n_devices`` ranks, any factorization of the world size.  Raises
    ``ValueError`` when ``n_devices`` does not divide by ``model_parallel
    × pods``."""
    import torch

    if n_devices % (model_parallel * pods):
        raise ValueError(
            f"{n_devices} devices not divisible by model={model_parallel} "
            f"× pods={pods}")
    data = n_devices // (model_parallel * pods)
    dev_type = _device_type(device)
    _ensure_world(device)
    ranks = torch.arange(n_devices)
    if pods > 1:
        return _mesh(dev_type, ranks.reshape(pods, data, model_parallel),
                     ("pod", "data", "model"))
    return _mesh(dev_type, ranks.reshape(data, model_parallel),
                 ("data", "model"))


def make_combining_mesh(n_shards: int, devices: Optional[Sequence[int]] = None,
                        *, device=None):
    """1-D ``("shard",)`` mesh for the combining tier (DESIGN.md §18).

    Places the K shard rows of a sharded structure across ``D`` ranks,
    where ``D`` is the LARGEST divisor of ``n_shards`` that fits the world
    (every rank holds K/D whole shard rows; a divisor always exists, and
    D = 1 is the one-rank mesh whose collective twin still runs — the
    tier-1 parity anchor and the one-card case).  ``devices``: the ranks
    to choose from (default every rank of the default group, which this
    starts when none is initialized); ``device``: ``None`` means the
    card, the tests pass ``"cpu"``."""
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    dev_type = _device_type(device)
    world = _ensure_world(device)
    ranks = list(devices) if devices is not None else list(range(world))
    d = max(g for g in range(1, min(len(ranks), n_shards) + 1)
            if n_shards % g == 0)
    return _mesh(dev_type, ranks[:d], ("shard",))


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], str, Optional[str]]:
    """(dp_axes, tensor_axis, pod_axis-or-None) for a production mesh."""
    names = tuple(mesh.mesh_dim_names)
    pod = "pod" if "pod" in names else None
    dp = tuple(n for n in names if n in ("pod", "data"))
    return dp, "model", pod
