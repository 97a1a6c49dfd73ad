"""Device mesh and sharding rules: the port of the JAX package's
``parallel/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
one launch, with the JAX axis names:
  - ``data``: batch sharding (DP); gradients are summed over it;
  - ``model``: tensor parallelism (TP) over the wide channel dims: the
    DenseConcat fusions Megatron-style (first projection column-parallel,
    second row-parallel) and every conv's output channels;
  - ``dcn``: on a hybrid mesh (``dcn > 1``), the slow inter-host axis. The
    batch shards over (dcn, data) jointly, and TP stays inside a host.

One rank drives one device: the card (NCCL) by default, the CPU (gloo) only
when the caller passes ``device="cpu"``. The process group comes from the
launch (``torchrun``'s environment, or explicit arguments); a mesh whose
rank count the launch does not provide raises ``ValueError``.

The rules (``param_shard_dim``, ``zero_extend``) are the JAX package's
PartitionSpec rules on the port's ``state_dict`` names and layouts.
``checkpoint_mesh`` and ``placements`` say where a rank's TP and ZeRO
slices lie in the whole tensor, for the sharded checkpoints;
``checkpoint_ranks``, ``tp_dims`` and ``shard_box`` compute the same with
no process group (one process can then cut every rank's slices).
"""
from __future__ import annotations

import datetime
import math
import os
import re
import socket

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from ..device import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def distributed_init(device="cuda", init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     timeout: float | None = None) -> torch.device:
    """Join the default process group (idempotent) and return this rank's
    device: ``cuda:LOCAL_RANK`` with NCCL, or the CPU with gloo.

    Arguments default to torchrun's environment (``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``). A process started
    without them is a launch of one rank, and joins a group of one at a
    free localhost port. A group already joined with the other backend
    raises. ``timeout``: seconds a collective waits for the other ranks
    before it raises (None: PyTorch's default).
    """
    dev = torch.device(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"no process-group backend for device {device!r}")
    backend = BACKENDS[dev.type]
    if dev.type == "cuda":
        resolve_device("cuda")
    env = os.environ
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                               f"device {device!r} needs {backend}")
    else:
        world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
        rank = int(env.get("RANK", 0)) if rank is None else rank
        if init_method is None:
            if "MASTER_ADDR" in env:
                init_method = "env://"
            elif world_size == 1:
                init_method = f"tcp://localhost:{free_port()}"
            else:
                raise ValueError(f"a launch of {world_size} ranks needs an init_method "
                                 "(or torchrun's MASTER_ADDR/MASTER_PORT)")
        if dev.type == "cuda":
            torch.cuda.set_device(_local_cuda_index(rank))
        kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, **kw)
    if dev.type == "cuda":
        return torch.device("cuda", _local_cuda_index(dist.get_rank()))
    return torch.device("cpu")


def launch_world_size() -> int:
    """The launch's rank count: the joined group's, else torchrun's
    ``WORLD_SIZE``, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def _local_cuda_index(rank: int) -> int:
    local = int(os.environ.get("LOCAL_RANK", rank))
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {local} has no card of its own "
                           f"({torch.cuda.device_count()} visible)")
    return local


def make_mesh(data: int = 1, model: int = 1, dcn: int = 1, device="cuda") -> DeviceMesh:
    """A (data, model) mesh, or (dcn, data, model) when ``dcn > 1``, over
    every rank of the launch (``distributed_init`` first). Raises
    ``ValueError`` when the launch has another number of ranks."""
    n = dcn * data * model
    world = launch_world_size()
    if n != world:
        raise ValueError(f"mesh {f'{dcn}x' if dcn > 1 else ''}{data}x{model} needs {n} "
                         f"ranks, the launch has {world}")
    distributed_init(device)
    if dcn > 1:
        mesh = init_device_mesh(torch.device(device).type, (dcn, data, model),
                                mesh_dim_names=("dcn", "data", "model"))
        # the batch axes (dcn, data) jointly: one group per model coordinate,
        # created by every rank in the same order
        groups = [dist.new_group(mesh.mesh[:, :, m].flatten().tolist())
                  for m in range(model)]
        mesh._mmst_batch_group = groups[mesh.get_local_rank("model")]
        return mesh
    return init_device_mesh(torch.device(device).type, (data, model),
                            mesh_dim_names=("data", "model"))


def make_axis_mesh(n: int | None = None, axis_name: str = "time", device="cuda") -> DeviceMesh:
    """A one-axis mesh over every rank of the launch (the JAX package's
    ``Mesh(devices, ("time",))``); ``n`` defaults to the launch's size and
    must equal it."""
    world = launch_world_size()
    n = world if n is None else n
    if n != world:
        raise ValueError(f"a {n}-rank '{axis_name}' axis, the launch has {world} ranks")
    distributed_init(device)
    return init_device_mesh(torch.device(device).type, (n,), mesh_dim_names=(axis_name,))


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh: DeviceMesh | None, name: str) -> int:
    return 1 if mesh is None else mesh_shape(mesh).get(name, 1)


def axis_group(mesh: DeviceMesh | None, name: str):
    """The process group of axis ``name``, or None (no mesh, or no such axis)."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return None
    return mesh.get_group(name)


def axis_rank(mesh: DeviceMesh | None, name: str) -> int:
    if mesh is None or name not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(name)


def batch_axes(mesh: DeviceMesh | None) -> tuple[str, ...]:
    """The batch-sharding axes: ``("dcn", "data")`` on a hybrid mesh, else
    ``("data",)`` (the JAX package's ``batch_pspec``)."""
    if mesh is not None and "dcn" in mesh.mesh_dim_names:
        return ("dcn", "data")
    return ("data",)


def batch_group(mesh: DeviceMesh | None):
    if mesh is not None and "dcn" in mesh.mesh_dim_names:
        return mesh._mmst_batch_group
    return axis_group(mesh, "data")


def batch_size(mesh: DeviceMesh | None) -> int:
    return math.prod(axis_size(mesh, a) for a in batch_axes(mesh))


def batch_rank(mesh: DeviceMesh | None) -> int:
    """This rank's index along the batch axes (dcn-major, as JAX's
    ``P(("dcn", "data"))`` lays the batch out)."""
    r = 0
    for a in batch_axes(mesh):
        r = r * axis_size(mesh, a) + axis_rank(mesh, a)
    return r


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def param_shard_dim(name: str, shape, model_size: int) -> int | None:
    """The dim of the parameter ``name`` (a PerformanceNet ``state_dict``
    key, torch layout) that TP shards over the model axis, or None
    (replicated): the JAX package's ``param_pspec`` (``mesh.py:97-118``).

      - DenseConcat fc1 (``fc1.weight`` (hidden, in), flax ``Dense_0``):
        column-parallel, dim 0; its bias too;
      - DenseConcat fc2 (``fc2.weight`` (out, hidden), flax ``Dense_1``):
        row-parallel, dim 1; its bias replicated;
      - conv and transposed-conv weights: the out channels (Conv1d (out,
        in, k) dim 0, ConvTranspose1d (in, out, k) dim 1; flax kernels
        (k, in, out) dim 2); their biases replicated;
      - anything else, and any dim the axis does not divide: replicated.
    """
    if model_size <= 1:
        return None
    shape = tuple(shape)
    if re.search(r"\.fc1\.(weight|bias)$", name):
        return 0 if shape[0] % model_size == 0 else None
    if re.search(r"\.fc2\.weight$", name):
        return 1 if shape[1] % model_size == 0 else None
    if name.endswith(".weight") and len(shape) == 3:
        out_dim = 1 if _is_conv_transpose(name) else 0
        return out_dim if shape[out_dim] % model_size == 0 else None
    return None


def _is_conv_transpose(name: str) -> bool:
    return name == "lastconv.weight" or name.endswith(".upconv.weight")


def zero_extend(shape, n: int, taken: int | None = None) -> int | None:
    """ZeRO-1's dim for a state tensor of ``shape`` over ``n`` batch ranks:
    the largest dim other than ``taken`` (the one TP already shards) that
    ``n`` divides, or None (the tensor stays whole on every rank). The
    JAX package's ``zero_extend_spec`` (``mesh.py:167-190``)."""
    if n <= 1:
        return None
    best, best_size = None, 0
    for i, d in enumerate(shape):
        if i != taken and d % n == 0 and d > best_size:
            best, best_size = i, d
    return best


def per_rank_bytes(tensors) -> int:
    """Bytes of ``tensors`` held on this rank."""
    return sum(t.numel() * t.element_size() for t in tensors)


def per_device_param_bytes(params) -> tuple[int, int]:
    """(bytes held on this rank, bytes of the whole) of ``params`` (the JAX
    package's ``per_device_param_bytes``): a module's parameters, a dict or
    an iterable of tensors. A DTensor counts its local shard here and its
    global shape in the whole; a plain tensor counts whole in both, except a
    tensor-parallel ``PerformanceNet``'s slices (``tp_dims``), which count
    as the model axis's size times the slice in the whole."""
    from torch.distributed.tensor import DTensor

    from . import comm

    whole = {}
    if isinstance(params, torch.nn.Module):
        if hasattr(params, "tp_dims"):
            n = comm.group_size(params.tp_group())
            whole = {k: n for k in params.tp_dims()}
        items = params.named_parameters()
    else:
        items = params.items() if isinstance(params, dict) else enumerate(params)
    per = total = 0
    for name, p in items:
        local = p.to_local() if isinstance(p, DTensor) else p
        per += local.numel() * local.element_size()
        total += p.numel() * p.element_size() * whole.get(name, 1)
    return per, total


def _checkpoint_order(names: tuple[str, ...]) -> tuple[str, ...]:
    batch = ("dcn", "data") if "dcn" in names else ("data",)
    return tuple(a for a in ("model", *batch) if a in names)


def checkpoint_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """``mesh``'s ranks ordered (model, *batch axes), a mesh with no process
    groups of its own: the mesh the checkpoints' DTensors are placed on.
    TP slices a tensor first and ZeRO slices that rank's TP slice over the
    batch axes (dcn-major), so where both take one dim the model axis is
    the outer split; DTensor splits along its mesh's dims in their order."""
    names = tuple(mesh.mesh_dim_names)
    order = _checkpoint_order(names)
    ranks = mesh.mesh.permute(*(names.index(a) for a in order)).contiguous()
    return DeviceMesh(mesh.device_type, ranks, mesh_dim_names=order, _init_backend=False)


def checkpoint_ranks(shape: dict[str, int]) -> tuple[tuple[str, ...], np.ndarray]:
    """``checkpoint_mesh`` of a ``make_mesh`` mesh of ``shape`` (axis name ->
    size, in the mesh's order, e.g. ``{"data": 2, "model": 2}``) as (axis
    names, grid of ranks), with no process group: ``make_mesh`` numbers
    the ranks in row-major order of its axes."""
    names = tuple(shape)
    order = _checkpoint_order(names)
    grid = np.arange(math.prod(shape.values())).reshape(tuple(shape.values()))
    return order, grid.transpose([names.index(a) for a in order])


def tp_dims(shapes: dict[str, tuple], model_size: int) -> dict[str, int]:
    """{state_dict key: sharded dim} of a PerformanceNet's tensor-parallel
    parameters over a model axis of ``model_size``, from the whole
    parameters' shapes: a weight along ``param_shard_dim``, its bias with
    it where that bias has a dim of its own. ``shard_tensor_parallel_``
    shards the live model so, and ``loop.rank_orbax_state`` cuts a rank's
    blocks so."""
    out = {}
    for key, shape in shapes.items():
        if not key.endswith(".weight"):
            continue
        dim = param_shard_dim(key, shape, model_size)
        if dim is None:
            continue
        out[key] = dim
        bias = key[:-len("weight")] + "bias"
        if bias in shapes and param_shard_dim(bias, shapes[bias], model_size) is not None:
            out[bias] = 0
    return out


def shard_box(ranks: np.ndarray, rank: int, places: list, shape) -> tuple[tuple, tuple, bool]:
    """(offset, size, written) of rank ``rank``'s block of a tensor of
    ``shape`` placed by ``places`` (``placements``) on a checkpoint mesh
    whose grid of ranks is ``ranks``: mesh dims split in their order, and
    of the ranks that hold one block the one at coordinate 0 on every
    replicated dim writes it (``written``). A split that leaves a
    remainder raises ``ValueError`` (the rules replicate such dims)."""
    coord = np.argwhere(np.asarray(ranks) == rank)
    if len(coord) != 1:
        raise ValueError(f"rank {rank} is not on the checkpoint mesh {np.asarray(ranks).tolist()}")
    offset, size, written = [0] * len(shape), list(shape), True
    for c, n, p in zip(coord[0], np.shape(ranks), places):
        if isinstance(p, Shard):
            if size[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split {n} ways")
            size[p.dim] //= n
            offset[p.dim] += int(c) * size[p.dim]
        elif c:
            written = False
    return tuple(offset), tuple(size), written


def placements(ckpt_mesh: DeviceMesh | tuple[str, ...], tp_dim: int | None,
               zero_dim: int | None) -> list:
    """The DTensor placements on ``checkpoint_mesh`` (or on a checkpoint
    mesh of these axis names, ``checkpoint_ranks``) of a tensor whose TP
    slice is along ``tp_dim`` and whose ZeRO slice (of the TP slice) is
    along ``zero_dim`` (None: whole over that axis)."""
    def on(dim):
        return Replicate() if dim is None else Shard(dim)

    names = ckpt_mesh if isinstance(ckpt_mesh, tuple) else ckpt_mesh.mesh_dim_names
    return [on(tp_dim if name == "model" else zero_dim) for name in names]
