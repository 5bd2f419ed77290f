"""The device mesh over torch.distributed, and its sharding rules.

Counterpart of visrag_tpu/mesh.py. The JAX package is one controller over
a mesh of devices; the port runs one process per GPU (a rank), and the
mesh is a `DeviceMesh` over those ranks with the JAX axis names:

  replica — across nodes (the HSDP outer axis; weights replicated)
  data    — data parallelism and FSDP
  seq     — sequence parallelism (Ulysses all_to_all, ring attention)
  model   — tensor parallelism for serving

Ranks fill the mesh in axis order (replica, data, seq, model), model
fastest, as the JAX package reshapes its device list. Each axis is a
process group, and so are the two flattened axis sets the port reduces
over: (replica, data), the batch's split, and (replica, data, seq), the
ranks that share the weights when model is 1. Every gloo group (the CPU
tests' backend) is made with GLOO_TIMEOUT, so that a collective one rank
never reaches fails within 90 s; NCCL groups keep the library's
default, which outlasts a rank-0 checkpoint write or a slow weight load
that the other ranks wait for at a barrier.

On the card the groups are NCCL's on cuda:LOCAL_RANK; on the CPU they are
gloo's. Without a process group (one process, nothing configured) the
callers take mesh=None and run their one-device path, where every
collective below is a no-op.

Tensor parallelism (serving, the RL rollout) runs on the `model` group:
`shard_module_tp` cuts a whole module into a rank's shard by
`tp_param_spec` (q/k/v and their output projection by whole heads), and
`load_tp_shard` refills it from the whole module or its FSDP2 shards.
"""

from __future__ import annotations

import contextlib
import datetime
import itertools
import math
import os
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from .config import MeshConfig

REPLICA, DATA, SEQ, MODEL = "replica", "data", "seq", "model"
BATCH_AXES = (REPLICA, DATA)
WEIGHT_AXES = (REPLICA, DATA, SEQ)
GLOO_TIMEOUT = datetime.timedelta(seconds=90)

MeshLike = Union[DeviceMesh, Mapping[str, int]]


def _env_int(*names) -> Optional[int]:
    for name in names:
        if os.environ.get(name) not in (None, ""):
            return int(os.environ[name])
    return None


def init_distributed(coordinator: Optional[str] = None,
                     process_id: Optional[int] = None,
                     num_processes: Optional[int] = None,
                     device="cuda"):
    """Join the job's process group: the torchrun / multi-host bootstrap.
    Call once per process before any collective.

    Flags beat env vars: the coordinator (host:port of process 0) from
    --coordinator or VISRAG_COORDINATOR, with VISRAG_PROCESS_ID /
    VISRAG_NUM_PROCESSES; else torchrun's MASTER_ADDR / MASTER_PORT /
    RANK / WORLD_SIZE. Nothing configured → one process and no group,
    (0, 1). A group that exists already is kept. On a CUDA `device` the
    backend is NCCL and this process takes cuda:LOCAL_RANK (or the process
    id modulo the cards when LOCAL_RANK is not set); on the CPU it is
    gloo. → (rank, world size)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coordinator = coordinator or os.environ.get("VISRAG_COORDINATOR")
    if coordinator is not None:
        rank = process_id if process_id is not None \
            else _env_int("VISRAG_PROCESS_ID")
        world = num_processes if num_processes is not None \
            else _env_int("VISRAG_NUM_PROCESSES")
        if rank is None or world is None:
            raise ValueError(f"coordinator {coordinator}: the process id and "
                             "the number of processes are needed too")
        init_method = f"tcp://{coordinator}"
    elif _env_int("RANK") is not None and "MASTER_ADDR" in os.environ:
        rank, world = _env_int("RANK"), _env_int("WORLD_SIZE")
        init_method = "env://"
    elif (num_processes or _env_int("WORLD_SIZE") or 1) > 1:
        raise ValueError(
            f"{num_processes or os.environ.get('WORLD_SIZE')} processes but "
            "no coordinator: give --coordinator (or VISRAG_COORDINATOR), or "
            "launch with torchrun")
    else:
        return 0, 1
    device = torch.device(device)
    if device.type == "cuda":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None
                              else rank % torch.cuda.device_count())
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=_timeout(backend))
    return rank, world


@contextlib.contextmanager
def distributed(coordinator=None, process_id=None, num_processes=None,
                device="cuda"):
    """init_distributed for the span of a `with` block: a group this call
    made is destroyed on the way out; one that existed before is kept.
    Yields (rank, world size)."""
    made = not dist.is_initialized()
    rank, world = init_distributed(coordinator, process_id, num_processes,
                                   device)
    try:
        yield rank, world
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def _timeout(backend: str) -> Optional[datetime.timedelta]:
    """GLOO_TIMEOUT for gloo; None (the library's default) for NCCL."""
    return GLOO_TIMEOUT if backend == "gloo" else None


def local_device(device="cuda") -> torch.device:
    """This rank's device: cuda:<current> for a CUDA device, else the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return device


def mesh_shape(cfg: Optional[MeshConfig], n: int) -> dict:
    """The fill rule of the JAX build_mesh: axes set to -1 (or 0) take what
    the fixed ones leave, the last of them all of it and the others 1.
    → {axis: size} whose product is n; ValueError otherwise."""
    cfg = cfg or MeshConfig()
    sizes = {REPLICA: cfg.replica, DATA: cfg.data, SEQ: cfg.seq,
             MODEL: cfg.model}
    fixed = math.prod(v for v in sizes.values() if v > 0)
    free = [k for k, v in sizes.items() if v <= 0]
    if free:
        if n % fixed != 0:
            raise ValueError(f"{n} devices not divisible by fixed axes "
                             f"{sizes}")
        for k in free[:-1]:
            sizes[k] = 1
        sizes[free[-1]] = n // fixed
    if math.prod(sizes.values()) != n:
        raise ValueError(f"mesh {sizes} != {n} devices")
    return {a: sizes[a] for a in cfg.axis_names}


def _rank_grid(shape: Mapping[str, int]) -> np.ndarray:
    return np.arange(math.prod(shape.values())).reshape(
        tuple(shape.values()))


def _groups_over(shape: Mapping[str, int], axes: Sequence[str]):
    """This rank's group among those that vary `axes` with every other
    axis fixed (every rank makes every group, in the same order)."""
    names = list(shape)
    grid = _rank_grid(shape)
    inner = [names.index(a) for a in axes]
    outer = [i for i in range(len(names)) if i not in inner]
    lists = grid.transpose(outer + inner).reshape(
        -1, math.prod(shape[a] for a in axes)).tolist()
    mine, _ = dist.new_subgroups_by_enumeration(
        lists, timeout=_timeout(dist.get_backend()))
    return mine


def build_mesh(cfg: Optional[MeshConfig] = None,
               device_type: Optional[str] = None) -> DeviceMesh:
    """The job's DeviceMesh with the JAX axis names, sized by the JAX fill
    rule over the world size; needs a process group (init_distributed).
    The flattened (replica, data) and (replica, data, seq) groups are kept
    on the mesh for axis_group. `device_type`: where the ranks' tensors
    live, by default "cuda" under NCCL and "cpu" under gloo; "cuda" under
    gloo for ranks that share one card (gloo carries CUDA tensors)."""
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a process group: call "
                           "mesh.init_distributed first (one process "
                           "without one runs with mesh=None)")
    shape = mesh_shape(cfg, dist.get_world_size())
    device_type = device_type or (
        "cuda" if dist.get_backend() == "nccl" else "cpu")
    groups = [_groups_over(shape, (a,)) for a in shape]
    mesh = DeviceMesh.from_group(
        groups, device_type, mesh=torch.from_numpy(_rank_grid(shape)),
        mesh_dim_names=tuple(shape))
    mesh.visrag_groups = {axes: _groups_over(shape, axes)
                          for axes in (BATCH_AXES, WEIGHT_AXES)}
    return mesh


def single_device_mesh(device="cuda") -> DeviceMesh:
    """A one-rank mesh: a one-process group is made at a free localhost
    port when none exists (the JAX single_device_mesh's role)."""
    if not dist.is_initialized():
        init_distributed(f"localhost:{free_port()}", 0, 1, device)
    if dist.get_world_size() != 1:
        raise ValueError(f"single_device_mesh in a job of "
                         f"{dist.get_world_size()} processes")
    return build_mesh(MeshConfig(data=1))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def axis_sizes(mesh: MeshLike) -> dict:
    """{axis: size} of a DeviceMesh or of a plain mapping (the rules below
    take either)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return {REPLICA: 1, DATA: 1, SEQ: 1, MODEL: 1, **dict(mesh)}


def axis_size(mesh: Optional[MeshLike], *axes: str) -> int:
    if mesh is None:
        return 1
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def axis_index(mesh: Optional[DeviceMesh], *axes: str) -> int:
    """This rank's coordinate along `axes` flattened in their order (0
    without a mesh)."""
    if mesh is None:
        return 0
    idx = 0
    for a in axes:
        idx = idx * axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx


def axis_group(mesh: DeviceMesh, *axes: str):
    """The process group of one axis, or of (replica, data) or (replica,
    data, seq) flattened."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh.visrag_groups[tuple(axes)]


def sub_mesh(mesh: DeviceMesh, *axes: str) -> DeviceMesh:
    """A mesh over `axes`: a slice of `mesh` for one axis or (replica,
    data) (FSDP2's HSDP mesh), else a 1-D mesh over the flattened group."""
    if len(axes) == 1 or axes == BATCH_AXES:
        return mesh[axes]
    group = axis_group(mesh, *axes)
    return DeviceMesh.from_group(
        group, mesh.device_type,
        mesh=torch.tensor(dist.get_process_group_ranks(group)),
        mesh_dim_names=("_".join(axes),))


def multihost_mesh_config(cfg: MeshConfig, num_nodes: int) -> MeshConfig:
    """The mesh layout of a run over `num_nodes` nodes: the replica axis
    spans nodes (weights replicated across them, the HSDP outer axis) and
    the data axis fills each node's GPUs. With one process per GPU the
    node count is WORLD_SIZE / LOCAL_WORLD_SIZE (num_nodes_of_job). An
    explicit replica axis wins; it must be a multiple of the node count,
    so that each node holds whole replicas."""
    import dataclasses
    if num_nodes <= 1:
        return cfg
    if cfg.replica in (1, -1, 0):
        return dataclasses.replace(cfg, replica=num_nodes)
    if cfg.replica % num_nodes != 0:
        raise ValueError(
            f"replica={cfg.replica} not a multiple of num_processes="
            f"{num_nodes}: replicas would straddle nodes")
    return cfg


def num_nodes_of_job() -> int:
    """WORLD_SIZE / LOCAL_WORLD_SIZE under torchrun; 1 otherwise (one node,
    or processes started by hand with the coordinator flags)."""
    if not dist.is_initialized():
        return 1
    local = _env_int("LOCAL_WORLD_SIZE") or dist.get_world_size()
    return max(dist.get_world_size() // local, 1)


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------


def fsdp_param_spec(shape: tuple, mesh: MeshLike,
                    min_size: int = 2 ** 16) -> tuple:
    """The ZeRO-3 rule of the JAX package: a parameter of min_size elements
    or more is sharded over `data` along its largest axis that the data
    size divides; smaller ones, and ones no axis of which divides, stay
    replicated. → a PartitionSpec-like tuple, one entry per axis: DATA or
    None."""
    n_data = axis_size(mesh, DATA)
    none = (None,) * len(shape)
    if n_data <= 1 or math.prod(shape) < min_size:
        return none
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % n_data == 0:
            return tuple(DATA if j == i else None for j in range(len(shape)))
    return none


def fsdp_shard_dim(shape: tuple, mesh: MeshLike) -> int:
    """The axis FSDP2 shards a parameter on: fsdp_param_spec's data axis,
    or 0 where the rule replicates (FSDP2 shards every parameter; the
    result is the same, only the memory differs)."""
    spec = fsdp_param_spec(shape, mesh)
    return spec.index(DATA) if DATA in spec else 0


# Megatron-style tensor-parallel rules for weights in torch's (out, in)
# layout: column-parallel layers shard the out dim, their row-parallel
# partners the in dim, so that a pair needs one all-reduce. The name sets
# cover the HF names and the JAX package's own.
_TP_COL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "attn_qkv",
           "mlp_fc1", "kv_proj", "lm_head",
           "attn_q", "attn_k", "attn_v", "mlp_gate", "mlp_up")
_TP_ROW = ("o_proj", "down_proj", "attn_proj", "mlp_fc2", "out_proj",
           "attn_o", "mlp_down")


def tp_param_spec(path: Sequence[str], shape: tuple, mesh: MeshLike) -> tuple:
    """The tensor-parallel rule by module path (serving-time TP): a
    vocab-sharded embedding, column-parallel out dims, row-parallel in
    dims, the rest replicated over `model`. → a PartitionSpec-like tuple
    of MODEL or None."""
    n_model = axis_size(mesh, MODEL)
    spec = [None] * len(shape)
    if n_model <= 1 or len(shape) < 1:
        return tuple(spec)
    names = _names(path)
    # the JAX embedding's leaf is "embedding"; an nn.Embedding's "weight"
    embedding = bool(path) and (path[-1] == "embedding" or tuple(
        path[-2:]) == ("embed_tokens", "weight"))
    if embedding and len(shape) == 2 and shape[0] % n_model == 0:
        spec[0] = MODEL
    elif any(n in names for n in _TP_COL) and shape[0] % n_model == 0:
        spec[0] = MODEL
    elif any(n in names for n in _TP_ROW) and len(shape) >= 2 \
            and shape[-1] % n_model == 0:
        spec[-1] = MODEL
    return tuple(spec)


# column-parallel layers whose outputs feed something other than their
# row-parallel pair: gathered over the group after the GEMM (the
# resampler's kv_proj would be one, but the resampler stays whole)
_TP_GATHER = ("lm_head",)


def _names(path: Sequence[str]) -> set:
    """A module path's names, and each pair of neighbours joined by "_"
    (the HF attn.qkv is the JAX attn_qkv)."""
    return set(path) | {f"{a}_{b}" for a, b in zip(path, path[1:])}


def _head_rows(parent, attr: str, tp: int, rank: int):
    """Head-aligned cuts inside an attention module that declares
    `tp_heads = (h, kvh, d)`: → ("col" | "row", row or column indices) for
    its q/k/v projections (fused `qkv`: q, k and v stacked on dim 0, each
    third cut by heads) and its output projection, or None to keep the
    layer whole. A fused qkv whose heads tp does not divide (a small
    vision tower) stays whole with its projection; separate q/k/v, whose
    K/V go to the paged pools, take serving/paged_kv.tp_head_layout, which
    raises on a layout no rank can hold."""
    from .serving.paged_kv import tp_head_layout
    h, kvh, d = parent.tp_heads
    fused = hasattr(parent, "qkv")
    if fused and h % tp:
        return None
    q0, hq, k0, hk = tp_head_layout(h, kvh, tp, rank)
    q = torch.arange(q0 * d, (q0 + hq) * d)
    if attr in ("o_proj", "proj"):
        return "row", q
    if attr == "qkv":
        return "col", torch.cat([q + i * h * d for i in range(3)])
    if attr == "q_proj":
        return "col", q
    if attr in ("k_proj", "v_proj"):
        return "col", torch.arange(k0 * d, (k0 + hk) * d)
    return None


_HEAD_LAYERS = ("qkv", "proj", "q_proj", "k_proj", "v_proj", "o_proj")


def _tp_role(path, module, parent, tp: int, rank: int, mesh):
    """How the rank holds one nn.Linear / nn.Embedding: (role, indices)
    with role "col" (out rows), "gather" (out rows, outputs gathered),
    "row" (in columns) or "vocab" (embedding rows); None: whole."""
    if hasattr(parent, "tp_heads") and path[-1] in _HEAD_LAYERS:
        return _head_rows(parent, path[-1], tp, rank)
    shape = tuple(module.weight.shape)
    spec = tp_param_spec(tuple(path) + ("weight",), shape, mesh)
    if MODEL not in spec:
        return None
    dim = spec.index(MODEL)
    n = shape[dim] // tp
    idx = torch.arange(rank * n, (rank + 1) * n)
    if isinstance(module, nn.Embedding):
        return "vocab", idx
    if dim == 1:
        return "row", idx
    gathered = any(n in _names(path) for n in _TP_GATHER)
    return ("gather" if gathered else "col"), idx


def _sliced_linear(cls, weight, bias):
    """A `cls` (an nn.Linear kind) holding the given tensors, built
    without allocating its full-size weight."""
    new = cls.__new__(cls)
    nn.Module.__init__(new)
    new.in_features, new.out_features = weight.shape[1], weight.shape[0]
    new.weight = nn.Parameter(weight, requires_grad=False)
    new.bias = None if bias is None else nn.Parameter(bias,
                                                      requires_grad=False)
    return new


@torch.no_grad()
def shard_module_tp(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """This rank's tensor-parallel shard of a whole module, for serving
    over the mesh's `model` group (the JAX shard_params_tp, one rank's
    part of it): a copy of `model` in which every nn.Linear and
    nn.Embedding that tp_param_spec shards holds the rank's slice —
    column-parallel layers their out rows (the LM head's outputs then
    gathered: models/common.GatheredLinear), row-parallel ones their in
    columns (common.RowParallelLinear: the partial products summed over
    the group, the bias added once after), the embedding its vocabulary
    rows (common.VocabParallelEmbedding) — where q/k/v and their output
    projection are cut by whole heads (_head_rows) and every other tensor
    is a whole copy. A subtree whose module sets `tp_whole = True` (the
    resampler) stays whole. The shard is inference only (requires_grad
    off) and records how each sliced tensor was cut, for load_tp_shard;
    `model` is left as it was, and the caller may free it."""
    import copy

    from .models.common import (GatheredLinear, QuantLinear,
                                RowParallelLinear, VocabParallelEmbedding)
    tp = axis_size(mesh, MODEL)
    group = axis_group(mesh, MODEL)
    rank = dist.get_rank(group)
    memo = {id(t): t for t in itertools.chain(model.parameters(),
                                              model.buffers())}
    shard = copy.deepcopy(model, memo)      # the structure; no tensor copied
    index = {}
    whole = set()
    for name, m in list(shard.named_modules()):
        if getattr(m, "tp_whole", False):
            whole.add(name)
        if any(name == w or name.startswith(w + ".") for w in whole) \
                or not isinstance(m, (nn.Linear, nn.Embedding)) or not name:
            continue
        path = name.split(".")
        parent = shard.get_submodule(".".join(path[:-1]))
        role = _tp_role(path, m, parent, tp, rank, mesh)
        if role is None:
            continue
        kind, idx = role
        if isinstance(m, QuantLinear):
            raise ValueError(
                f"{name}: an int8 layer cannot be sliced for tensor "
                "parallelism (a row-parallel slice would take its "
                "activation scales over part of each row: K6 would see "
                "other codes); serve it with quant='none'")
        w = m.weight.index_select(1 if kind == "row" else 0,
                                  idx.to(m.weight.device))
        b = m.bias if isinstance(m, nn.Linear) else None
        if kind == "vocab":
            new = VocabParallelEmbedding.from_pretrained(w)
            new.start = int(idx[0])
        elif kind == "row":
            new = _sliced_linear(RowParallelLinear, w, b)
        elif kind == "gather":
            new = _sliced_linear(GatheredLinear, w, None if b is None
                                 else b.index_select(0, idx.to(b.device)))
        else:
            new = _sliced_linear(type(m), w, None if b is None
                                 else b.index_select(0, idx.to(b.device)))
        if kind != "col":
            new.group = group
        setattr(parent, path[-1], new)
        dim = 1 if kind == "row" else 0
        index[name + ".weight"] = (dim, idx)
        if b is not None and kind != "row":
            index[name + ".bias"] = (0, idx)
    # every tensor not sliced above: a whole copy of the rank's own
    for m in shard.modules():
        for key, p in list(m._parameters.items()):
            if p is not None and id(p) in memo:
                m._parameters[key] = nn.Parameter(p.detach().clone(),
                                                  requires_grad=False)
        for key, b in list(m._buffers.items()):
            if b is not None and id(b) in memo:
                m._buffers[key] = b.clone()
    shard.requires_grad_(False)
    shard.tp_index = index
    shard.tp_group = group
    shard.tp_size = tp
    return shard


@torch.no_grad()
def load_tp_shard(shard: Optional[nn.Module], source: nn.Module,
                  skip: Sequence[str] = ()) -> None:
    """Refill a shard (shard_module_tp), or a whole copy, from `source`:
    the whole module it was cut from after an update, or that module under
    FSDP2 (each DTensor gathered whole, one tensor at a time and in one
    order: every rank of its mesh must call this, a rank with no shard
    passing None). Names starting with a prefix in `skip` (a frozen tower)
    are left out."""
    from torch.distributed.tensor import DTensor
    own = None if shard is None else shard.state_dict()
    index = getattr(shard, "tp_index", {})
    for name, t in source.state_dict().items():
        if any(name.startswith(s) for s in skip):
            continue
        if isinstance(t, DTensor):
            t = t.full_tensor()
        if own is None:
            continue
        cut = index.get(name)
        if cut is not None:
            t = t.index_select(cut[0], cut[1].to(t.device))
        own[name].copy_(t)


def local_batch_size(global_batch: int, mesh: Optional[MeshLike]) -> int:
    n = axis_size(mesh, *BATCH_AXES)
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n} "
                         "data shards")
    return global_batch // n


def local_slice(global_batch, mesh: Optional[DeviceMesh]):
    """This rank's contiguous block of dim 0 of a tensor, array or list,
    blocks in (replica, data) order: the JAX batch_sharding's split, so
    that the blocks gathered in rank order are the global batch."""
    if mesh is None:
        return global_batch
    n = local_batch_size(len(global_batch), mesh)
    i = axis_index(mesh, *BATCH_AXES)
    return global_batch[i * n:(i + 1) * n]


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's x (same shape) along dim 0 in rank order,
    without gradient (one all_gather_into_tensor)."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out
