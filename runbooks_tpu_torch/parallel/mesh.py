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

The port serves over the ``expert`` and ``tensor`` axes
(``check_serving_mesh``) and trains over ``data`` and ``fsdp``
(``check_training_mesh``): the other axes are refused by name until
their slices land (ROADMAP §1). ``check_mesh_model`` refuses gemma under
a mesh; an MoE model (mixtral) trains over ``data`` x ``fsdp``, routed
over the global microbatch as the reference routes it (models/moe.py),
and serves over ``expert`` x ``tensor``.
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
    """Refuse, by name, every resolved serving axis but ``expert`` and
    ``tensor`` above 1. ``stage`` as the reference's engine refuses it;
    the others wait for their slice, ROADMAP §1 item 4 (f). (A dense model
    under ``expert`` replicates over that axis, as the reference drops an
    axis that no dimension uses.)"""
    if config.stage > 1:
        raise ValueError(
            "pipeline (stage) parallelism is a training-path feature; "
            "serve with tensor/data parallelism instead (mesh_tensor)")
    for axis in ("data", "fsdp", "sequence"):
        if getattr(config, axis) > 1:
            raise NotImplementedError(
                f"mesh_{axis}={getattr(config, axis)}: the PyTorch port "
                f"serves over the expert and tensor axes only "
                f"(mesh_expert, mesh_tensor); {axis} parallelism is not "
                f"ported yet (ROADMAP.md §1)")


def serving_axes(config: MeshConfig) -> str:
    """The serving axes above 1 as params.json spells them
    ("mesh_expert=2, mesh_tensor=2")."""
    return ", ".join(f"mesh_{a}={getattr(config, a)}"
                     for a in ("expert", "tensor") if getattr(config, a) > 1)


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


def check_mesh_model(cfg, config: MeshConfig, serving: bool = False
                     ) -> None:
    """Refuse, by name, what the port does not run of a model under a
    mesh. Gemma (a config with ``embed_scale``) under ``mesh_tensor``,
    ``mesh_fsdp`` or ``mesh_data`` above 1, on either path (ROADMAP §1
    item 4 (c)). An MoE model (``moe_num_experts``: mixtral) trains
    (``serving`` False) under ``mesh_data`` and ``mesh_fsdp``, each rank
    routing its rows as the reference routes the global microbatch
    (models/moe.py), and not under ``mesh_tensor`` or ``mesh_expert``
    (ROADMAP §1 item 4 (d), (e); check_training_mesh refuses those axes
    for every model). It serves (``serving`` True) under ``tensor`` and
    ``expert``, where every rank holds the whole dispatch, and not under
    ``mesh_fsdp`` or ``mesh_data`` (item 4 (f)). Every other model
    passes."""
    def over(names):
        return [f"mesh_{a}={getattr(config, a)}" for a in names
                if getattr(config, a) > 1]

    axes = over(("tensor", "fsdp", "data"))
    if cfg.embed_scale and axes:
        raise NotImplementedError(
            f"config {cfg.name!r} (gemma: embed_scale) under "
            f"{', '.join(axes)}: the PyTorch port runs gemma on one device; "
            f"gemma under a mesh is not ported yet (ROADMAP.md §1 item 4 "
            f"(c))")
    moe_axes = over(("fsdp", "data") if serving else ("tensor", "expert"))
    if cfg.moe_num_experts and moe_axes:
        raise NotImplementedError(
            f"config {cfg.name!r} (MoE: moe_num_experts="
            f"{cfg.moe_num_experts}) under {', '.join(moe_axes)}"
            f"{' in serving' if serving else ' in training'}: the PyTorch "
            "port serves MoE under mesh_expert and mesh_tensor and trains "
            "it under mesh_data and mesh_fsdp; "
            + ("MoE serving over the batch axes is not ported yet "
               "(ROADMAP.md §1 item 4 (f))" if serving else
               "tensor and expert parallelism in training are not ported "
               "yet (ROADMAP.md §1 item 4 (d), (e))"))


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
