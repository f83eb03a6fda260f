"""The device mesh on torch.distributed (port of `neutts_tpu.parallel.mesh`).

One process per device. A `Mesh` records the world (size, this process's
rank and device) and its split into `dp` data-parallel ranks times `tp`
tensor-parallel ones, laid out as JAX lays out its devices
(`reshape(dp, tp)`): rank d*tp + t is (data d, model t). The batch is split
over the data axis and the trainers sum the gradients over `Mesh.group`,
the rank's data-axis group (`train.trainer.make_sharded_train_step`,
`train.codec_trainer.make_train_step`). The ranks of one model-axis group,
`Mesh.tp_group`, hold the same rows and split the weights by
`backbone_param_specs`, the JAX package's Megatron layout kept as data (for
each weight, the mesh axis or None of each dimension); `shard_params` cuts
a rank's slices and `parallel.tensor` holds the collectives between them.

A "sharding" here is the part of a tensor a rank holds: a `Shard` (this
rank's block of one dimension) or None for the whole tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from neutts_tpu_torch.config import BackboneConfig, require_qwen2
from neutts_tpu_torch.models.checkpoint import tree_to
from neutts_tpu_torch.parallel import tensor as tp_ops
from neutts_tpu_torch.pipeline import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    dp: int
    tp: int
    world_size: int
    rank: int
    device: torch.device  # this process's device
    # the rank's data-axis process group (the whole world at tp 1); None in
    # a single process
    group: Optional[object] = None
    tp_group: Optional[object] = None  # the rank's model-axis group; None at tp 1

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.tp}

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def dp_group(self):
        return self.group


def world() -> tuple:
    """(world size, rank): (1, 0) when torch.distributed is not initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def default_devices(device="cuda") -> list:
    """One device per rank: the local GPUs in turn for "cuda", else `device`."""
    dev = resolve_device(device)
    n, _ = world()
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", r % torch.cuda.device_count()) for r in range(n)]
    return [dev] * n


def make_mesh(dp: Optional[int] = None, tp: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A dp x tp mesh over `devices`, one per rank in rank order (default
    `default_devices()`). At tp > 1 every rank must call it, in the same
    order as its other process groups: it makes one group per row and per
    column of the mesh."""
    devices = [torch.device(d) for d in (devices if devices is not None else default_devices())]
    n, rank = world()
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a world of {n} processes")
    dp = n // tp if dp is None else dp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != device count ({n})")
    group = tp_group = None
    if dist.is_initialized():
        group = dist.group.WORLD
        if tp > 1:
            for d in range(dp):
                g = dist.new_group([d * tp + t for t in range(tp)])
                tp_group = g if rank // tp == d else tp_group
            for t in range(tp):
                g = dist.new_group([d * tp + t for d in range(dp)])
                group = g if rank % tp == t else group
    return Mesh(dp=dp, tp=tp, world_size=n, rank=rank, device=devices[rank], group=group,
                tp_group=tp_group)


def backbone_param_specs(cfg: BackboneConfig) -> dict:
    """Megatron TP layout of the JAX package: QKV, gate and up split on the
    output features, o and down on the input features, norms and the
    embedding replicated, an untied head split on the vocab."""
    specs = {
        "embed": (None, None),
        "layers": {
            "attn_norm": (None, None),
            "wq": (None, None, MODEL_AXIS),
            "bq": (None, MODEL_AXIS),
            "wk": (None, None, MODEL_AXIS),
            "bk": (None, MODEL_AXIS),
            "wv": (None, None, MODEL_AXIS),
            "bv": (None, MODEL_AXIS),
            "wo": (None, MODEL_AXIS, None),
            "mlp_norm": (None, None),
            "w_gate": (None, None, MODEL_AXIS),
            "w_up": (None, None, MODEL_AXIS),
            "w_down": (None, MODEL_AXIS, None),
        },
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, MODEL_AXIS)
    return specs


@dataclasses.dataclass(frozen=True)
class Shard:
    """Block `index` of `parts` equal blocks of dimension `dim`."""

    dim: int
    index: int
    parts: int

    def take(self, x: torch.Tensor) -> torch.Tensor:
        n, rem = divmod(x.shape[self.dim], self.parts)
        if rem:
            raise ValueError(f"{self.parts} ranks do not split dimension {self.dim} of "
                             f"{tuple(x.shape)}")
        return x.narrow(self.dim, self.index * n, n)


def _sharding(spec: tuple, mesh: Mesh) -> Optional[Shard]:
    if MODEL_AXIS not in spec or mesh.tp == 1:
        return None
    return Shard(spec.index(MODEL_AXIS), mesh.tp_rank, mesh.tp)


def backbone_param_shardings(mesh: Mesh, cfg: BackboneConfig) -> dict:
    """The part of each backbone weight this rank holds (`backbone_param_specs`
    over `mesh`): a `Shard` of the model axis, or None (replicated)."""
    def walk(t):
        return {k: walk(v) for k, v in t.items()} if isinstance(t, dict) else _sharding(t, mesh)

    return walk(backbone_param_specs(cfg))


def split_leaves(params, mesh: Mesh, cfg: BackboneConfig) -> list:
    """For each leaf of a backbone tree, in `tree_leaves` order: whether a
    rank holds a block of it (True) or all of it."""
    def walk(p, sh):
        return [f for k in p for f in walk(p[k], sh[k])] if isinstance(p, dict) else [
            sh is not None]

    return walk(params, backbone_param_shardings(mesh, cfg))


def batch_sharding(mesh: Mesh) -> Shard:
    """[B, ...] arrays: this rank's rows, its block of the data axis (the
    same rows on every rank of a model-axis group)."""
    return Shard(0, mesh.dp_rank, mesh.dp)


def replicated(mesh: Mesh) -> None:
    """The whole tensor on every rank."""
    return None


def kv_cache_spec() -> tuple:
    """[L, B, T, n_kv * Dh]: batch on data. The JAX package keeps every KV
    head on every rank of the model axis; a tensor-parallel rank of the port
    keeps only the KV heads its query heads read
    (`parallel.tensor.kv_head_span`)."""
    return (None, DATA_AXIS, None, None)


def shard_params(params, mesh: Mesh, cfg: BackboneConfig):
    """This rank's backbone weights on its device: at tp > 1 the block of
    each weight that the JAX `shard_params` places on device (data d, model
    t), rank d*tp + t, as its own copy; the tree itself at tp 1. Float
    weights only at tp > 1, as the JAX layout has no entries for the
    quantized leaves (nor for the speech head)."""
    require_qwen2(cfg, "tensor parallelism (parallel.mesh.shard_params)")
    if mesh.tp == 1:
        return tree_to(params, mesh.device)
    tp_ops.check_tp(cfg, mesh.tp)
    shardings = backbone_param_shardings(mesh, cfg)

    def walk(p, sh, path):
        if isinstance(sh, dict) and isinstance(p, dict) and set(p) == set(sh):
            return {k: walk(p[k], sh[k], f"{path}{k}/") for k in p}
        if not isinstance(p, torch.Tensor) or isinstance(sh, dict):
            raise ValueError(f"tensor parallelism takes the float backbone tree: {path or '/'} "
                             f"has {sorted(p) if isinstance(p, dict) else type(p).__name__}, "
                             f"the layout {sorted(sh) if isinstance(sh, dict) else 'a weight'}")
        if sh is None:
            return p.to(mesh.device)
        return sh.take(p).to(mesh.device, copy=True, memory_format=torch.contiguous_format)

    return walk(params, shardings, "")
