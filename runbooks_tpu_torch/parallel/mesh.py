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

The port serves over the ``tensor`` axis only (``check_serving_mesh``)
and trains over ``data`` and ``fsdp`` only (``check_training_mesh``): the
other axes are refused by name until their slices land (ROADMAP §1).
Gemma and MoE models (mixtral) run on one device only
(``check_mesh_model``).
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


def check_training_mesh(config: MeshConfig,
                        world: Optional[int] = None) -> MeshConfig:
    """Refuse, by name, every training axis but ``data`` and ``fsdp`` above
    1; with ``world`` (the ranks there are: on ``train/trainer.main`` the
    GPUs the process sees) resolve against it first, a -1 axis filling
    with it and a mesh of another size raising as the reference's. Returns
    the config (resolved when ``world`` is given)."""
    if world is not None:
        config = config.resolve(world)
    if config.stage > 1:
        raise NotImplementedError(
            f"mesh_stage={config.stage}: pipeline parallelism "
            "(parallel/pipeline.py) is not ported yet (ROADMAP.md §1); "
            "train over mesh_data and mesh_fsdp")
    for axis in ("expert", "sequence", "tensor"):
        if getattr(config, axis) > 1:
            raise NotImplementedError(
                f"mesh_{axis}={getattr(config, axis)}: the PyTorch port "
                f"trains over the data and fsdp axes only (mesh_data, "
                f"mesh_fsdp); {axis} parallelism in training is not ported "
                f"yet (ROADMAP.md §1)")
    return config


def check_mesh_model(cfg, config: MeshConfig) -> None:
    """Refuse, by name, gemma (a config with ``embed_scale``) and an MoE
    model (``moe_num_experts``: mixtral) under ``mesh_tensor``,
    ``mesh_fsdp`` or ``mesh_data`` above 1: the port runs them on one
    device only, and either under a mesh waits for ROADMAP §1 item 4
    (``mesh_expert`` is refused for every model by the serving and
    training checks). Every other model passes."""
    axes = [f"mesh_{a}={getattr(config, a)}"
            for a in ("tensor", "fsdp", "data") if getattr(config, a) > 1]
    if not axes:
        return
    if cfg.embed_scale:
        raise NotImplementedError(
            f"config {cfg.name!r} (gemma: embed_scale) under "
            f"{', '.join(axes)}: the PyTorch port runs gemma on one device; "
            f"gemma under a mesh is not ported yet (ROADMAP.md §1 item 4)")
    if cfg.moe_num_experts:
        raise NotImplementedError(
            f"config {cfg.name!r} (MoE: moe_num_experts="
            f"{cfg.moe_num_experts}) under {', '.join(axes)}: the PyTorch "
            "port runs MoE models on one device; the reference routes "
            "over the global batch (capacity, slots and the aux loss span "
            "every rank), and MoE under a mesh is not ported yet "
            "(ROADMAP.md §1 item 4)")


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
