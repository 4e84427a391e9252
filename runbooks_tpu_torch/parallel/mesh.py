"""Device-mesh construction (the port of ``runbooks_tpu.parallel.mesh``).

Axes, outermost to innermost, as the reference's:

  data      — pure data parallelism
  stage     — pipeline parallelism
  expert    — expert parallelism for MoE layers
  fsdp      — data parallelism with parameter/optimizer sharding
  sequence  — context/sequence parallelism (ring attention)
  tensor    — megatron-style tensor parallelism (innermost)

``MeshConfig`` and its ``resolve`` are the reference's, errors included.
``make_mesh`` builds a ``torch.distributed.device_mesh.DeviceMesh`` over
the processes of the default group (one process per GPU), shaped by the
resolved config and named by ``MESH_AXES``.

The port serves over the ``tensor`` axis only (``check_serving_mesh``):
the other axes are refused by name until their slices land (ROADMAP §1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

MESH_AXES = ("data", "stage", "expert", "fsdp", "sequence", "tensor")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Parallelism degrees. Use -1 for at most one axis to mean "fill with
    whatever devices remain"."""

    data: int = 1
    stage: int = 1
    expert: int = 1
    fsdp: int = -1
    sequence: int = 1
    tensor: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        sizes = {a: getattr(self, a) for a in MESH_AXES}
        fill = [a for a, s in sizes.items() if s == -1]
        if len(fill) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {fill}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if fill:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes[fill[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices but {n_devices} available"
            )
        return MeshConfig(**sizes)


def check_serving_mesh(config: MeshConfig) -> None:
    """Refuse, by name, every resolved serving axis but ``tensor`` above 1.
    ``stage`` as the reference's engine refuses it; the others wait for
    their slices of ROADMAP §1 item 5."""
    if config.stage > 1:
        raise ValueError(
            "pipeline (stage) parallelism is a training-path feature; "
            "serve with tensor/data parallelism instead (mesh_tensor)")
    for axis in ("data", "expert", "fsdp", "sequence"):
        if getattr(config, axis) > 1:
            raise NotImplementedError(
                f"mesh_{axis}={getattr(config, axis)}: the PyTorch port "
                f"serves over the tensor axis only (mesh_tensor); "
                f"{axis} parallelism is not ported yet (ROADMAP.md §1)")


def make_mesh(config: Optional[MeshConfig] = None,
              device_type: Optional[str] = None):
    """A DeviceMesh over every process of the default group (which must
    exist: ``parallel.distributed.initialize``), one device per process.
    ``device_type`` defaults to "cuda" under NCCL and "cpu" under gloo."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    config = (config or MeshConfig()).resolve(world)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    shape = tuple(getattr(config, a) for a in MESH_AXES)
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=MESH_AXES)


def mesh_config_of(mesh) -> MeshConfig:
    """The MeshConfig a DeviceMesh was built from."""
    return MeshConfig(**{a: mesh.size(MESH_AXES.index(a))
                         for a in MESH_AXES})
