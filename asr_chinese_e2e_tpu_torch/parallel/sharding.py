"""Process bootstrap, the (data, model, seq) mesh and the tensor-parallel
sharding rules (``asr_chinese_e2e_tpu/parallel/sharding.py``).

One process drives one device (``torchrun`` or ``initialize_distributed``
with an address). The mesh lays the ranks out as JAX lays out devices:
rank = (data_index * model + model_index) * seq + seq_index.

- ``data``: each rank trains (or decodes) its rows of the global batch
  (``shard_batch``); the gradients are summed over the axis, the loss
  being normalised over the global batch (``train/train_step.py``).
- ``model``: tensor parallelism. ``shard_model_`` keeps on each rank its
  chunk of every parameter a rule of ``param_spec`` matches (attention
  heads, the FFN's hidden width, the vocabulary of the tied embedding),
  and the layers sum or gather over the axis (``models/layers.py``).
  Adam's moments are made from the parameters, so they follow their
  parameter's chunk with no code (the JAX package's ``state_shardings``).
- ``seq``: ring attention (``attn_impl="ring"``, ``ops/ring_attention.py``).

Checkpoints hold whole tensors: ``gather_state`` joins the chunks before
a save and ``slice_state`` takes a rank's chunk from them on restore, so a
checkpoint of a sharded run loads into an unsharded model and back.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch
import torch.distributed as dist

from .collectives import all_gather_cat

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> tuple[int, int]:
    """Join the process group; returns (world size, rank), as
    ``jax.process_count()`` / ``process_index()``.

    ``coordinator_address`` is ``host:port`` of rank 0. With no arguments
    the group comes from ``torchrun``'s environment (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). One process is a no-op.
    ``backend`` defaults to NCCL when CUDA is available, else gloo; gloo
    also serves several ranks on one card."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
        process_id = int(os.environ.get("RANK", "0"))
        init_method = "env://"
    else:
        if num_processes > 1 and (coordinator_address is None or process_id is None):
            raise ValueError("num_processes > 1 needs coordinator_address and process_id")
        init_method = f"tcp://{coordinator_address}"
    if num_processes <= 1:
        return 1, 0
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)
    return dist.get_world_size(), dist.get_rank()


def local_rank() -> int:
    """This process's index among the processes of its host (``torchrun``'s
    ``LOCAL_RANK``; else the rank modulo the host's cards)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_rank() % max(torch.cuda.device_count(), 1)


def mesh_shape(n: int, data: int = -1, model: int = 1, seq: int = 1) -> dict:
    """{axis: size} of a mesh over ``n`` ranks; ``data=-1`` takes the rest."""
    if data == -1:
        assert n % (model * seq) == 0, (n, model, seq)
        data = n // (model * seq)
    assert data * model * seq <= n, (data, model, seq, n)
    return {DATA_AXIS: data, MODEL_AXIS: model, SEQ_AXIS: seq}


class Mesh:
    """This rank's view of the mesh: ``shape`` {axis: size}, and per axis
    its index (``index``) and process group (``group``, None for a size-1
    axis). ``device_mesh`` is the ``torch.distributed`` ``DeviceMesh``
    (None for a single process)."""

    def __init__(self, shape: dict, device_mesh=None, overrides: Optional[dict] = None):
        self.shape = dict(shape)
        self.device_mesh = device_mesh
        self._overrides = dict(overrides or {})

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS] * self.shape[SEQ_AXIS]

    def index(self, axis: str) -> int:
        if axis in self._overrides or self.shape[axis] == 1:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        if axis in self._overrides or self.shape[axis] == 1:
            return None
        return self.device_mesh.get_group(axis)

    def without(self, axis: str) -> "Mesh":
        """The same mesh with ``axis`` of size 1 here: what every rank of
        that axis computes alike (a batch that does not divide ``data``)."""
        shape = {**self.shape, axis: 1}
        return Mesh(shape, self.device_mesh, {**self._overrides, axis: True})

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(data: int = -1, model: int = 1, seq: int = 1,
              device_type: Optional[str] = None) -> Mesh:
    """The (data, model, seq) mesh over every rank of the process group
    (``init_device_mesh``); ``data=-1`` absorbs the ranks left. A single
    process needs no process group. ``device_type`` defaults to "cuda"
    under NCCL and "cpu" under gloo (the mesh carries only the groups; gloo
    reduces CUDA tensors all the same)."""
    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    want = (n if data == -1 else data) * (1 if data == -1 else model * seq)
    if want != n or n % (model * seq):
        raise ValueError(f"a ({data}, {model}, {seq}) mesh over a process group of {n} ranks")
    shape = mesh_shape(n, data, model, seq)
    if n == 1:
        return Mesh(shape)
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, tuple(shape[a] for a in AXES), mesh_dim_names=AXES)
    return Mesh(shape, dm)


# -- batches ---------------------------------------------------------------


def batch_rows(mesh: Optional[Mesh], bsz: int) -> slice:
    """This rank's rows of a global batch of ``bsz`` (all of them when the
    batch does not divide the data axis)."""
    dp = 1 if mesh is None else mesh.shape[DATA_AXIS]
    if dp == 1 or bsz % dp:
        return slice(0, bsz)
    per = bsz // dp
    d = mesh.index(DATA_AXIS)
    return slice(d * per, (d + 1) * per)


def shard_batch(mesh: Optional[Mesh], arrays):
    """This rank's rows of each array of a global host batch (a dict or a
    sequence); the JAX package's ``shard_batch`` / ``put_host_batch``,
    which place the global batch over the devices."""
    if isinstance(arrays, dict):
        rows = batch_rows(mesh, len(next(iter(arrays.values()))))
        return {k: v[rows] for k, v in arrays.items()}
    rows = batch_rows(mesh, len(arrays[0]))
    return [v[rows] for v in arrays]



# -- tensor-parallel rules --------------------------------------------------
# Matched against the port's parameter names (``models/convert.py``).
# q/k/v weights (H*dk, D) and biases: split by heads; the attention output
# weight (D, H*dk): by heads; FFN w1 (d_ff, D) and its bias: by d_ff; w2
# (D, d_ff): by d_ff; the tied embedding (V, D): by vocabulary. Everything
# else replicated (the out and w2 biases are added after the sum).
_TP_RULES = (
    (r".*attn\.(q|k|v)_proj\.weight$", (MODEL_AXIS, None), True),
    (r".*attn\.(q|k|v)_proj\.bias$", (MODEL_AXIS,), True),
    (r".*attn\.out_proj\.weight$", (None, MODEL_AXIS), True),
    (r"(.*\.)?w1\.weight$", (MODEL_AXIS, None), False),
    (r"(.*\.)?w1\.bias$", (MODEL_AXIS,), False),
    (r"(.*\.)?w2\.weight$", (None, MODEL_AXIS), False),
    (r"(.*\.)?embed\.weight$", (MODEL_AXIS, None), False),
)


def param_spec(name: str, shape: tuple, model_axis_size: int,
               head_dim: Optional[int] = None) -> tuple:
    """The parameter's partition: a tuple with ``MODEL_AXIS`` at the split
    dimension, or ``()`` (replicated). A rule applies only when the split
    divides: by heads (the dimension / ``head_dim``) for the attention's
    projections, else the dimension itself."""
    if model_axis_size > 1:
        for pattern, spec, by_heads in _TP_RULES:
            if not re.match(pattern, name):
                continue
            dim = spec.index(MODEL_AXIS)
            if dim >= len(shape):
                return ()
            units = shape[dim]
            if by_heads and head_dim:
                if units % head_dim:
                    return ()
                units //= head_dim
            return spec if units % model_axis_size == 0 else ()
    return ()


class TensorParallel:
    """How a layer is split over the ``model`` axis: ``mode`` "column"
    (weight rows, output features), "row" (weight columns, input
    features) or "vocab" (embedding rows); the axis' group, index and
    size."""

    def __init__(self, mode: str, group, index: int, size: int):
        self.mode, self.group, self.index, self.size = mode, group, index, size


def _head_dims(model) -> dict:
    """{projection module name: its attention's head_dim}."""
    from ..models.layers import MultiHeadAttention

    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, MultiHeadAttention):
            for sub in ("q_proj", "k_proj", "v_proj", "out_proj"):
                out[f"{name}.{sub}" if name else sub] = mod.head_dim
    return out


def param_shardings(model, mesh: Mesh) -> dict:
    """{parameter name: its partition} of an unsharded model (TP when the
    mesh's model axis is > 1, replicated otherwise)."""
    tp = mesh.shape[MODEL_AXIS]
    heads = _head_dims(model)
    return {
        name: param_spec(name, tuple(p.shape), tp, heads.get(name.rsplit(".", 1)[0]))
        for name, p in model.named_parameters()
    }


@torch.no_grad()
def shard_model_(model, mesh: Mesh) -> dict:
    """Keep on this rank its chunk of every parameter ``param_spec``
    splits over ``model``, and tell each split layer (``Dense``,
    ``Embedding``) how it is split. The parameters stay the same objects
    (their data is cut), so an optimizer made before holds them still.
    Returns {parameter name: partition} of the split ones."""
    from ..models.layers import Dense, Embedding

    tp = mesh.shape[MODEL_AXIS]
    if tp == 1:
        return {}
    group, m = mesh.group(MODEL_AXIS), mesh.index(MODEL_AXIS)
    specs = {k: v for k, v in param_shardings(model, mesh).items() if v}
    for name, mod in model.named_modules():
        w = f"{name}.weight" if name else "weight"
        if w not in specs:
            continue
        if not isinstance(mod, (Dense, Embedding)):
            raise TypeError(f"a tensor-parallel rule matched {w} of a {type(mod).__name__}")
        dim = specs[w].index(MODEL_AXIS)
        mode = "vocab" if isinstance(mod, Embedding) else ("column" if dim == 0 else "row")
        mod.weight.data = mod.weight.data.chunk(tp, dim)[m].clone()
        b = f"{name}.bias"
        if getattr(mod, "bias", None) is not None and b in specs:
            mod.bias.data = mod.bias.data.chunk(tp, 0)[m].clone()
        mod.tp = TensorParallel(mode, group, m, tp)
    return specs


def sharded_parameters(model) -> set:
    """ids of the parameters that hold a chunk of a split tensor."""
    out = set()
    for mod in model.modules():
        tp = getattr(mod, "tp", None)
        if tp is None:
            continue
        out.add(id(mod.weight))
        if tp.mode == "column" and getattr(mod, "bias", None) is not None:
            out.add(id(mod.bias))
    return out


def _split_params(model) -> dict:
    """{parameter name: (dim, TensorParallel)} of the split parameters."""
    out = {}
    for name, mod in model.named_modules():
        tp = getattr(mod, "tp", None)
        if tp is None:
            continue
        prefix = f"{name}." if name else ""
        out[prefix + "weight"] = (1 if tp.mode == "row" else 0, tp)
        if tp.mode == "column" and getattr(mod, "bias", None) is not None:
            out[prefix + "bias"] = (0, tp)
    return out


def gather_state(model, state_dict: dict) -> dict:
    """``state_dict`` of ``model`` with every split parameter joined whole
    (a collective: every rank of the model axis calls it)."""
    split = _split_params(model)
    return {k: (all_gather_cat(v, split[k][1].group, split[k][0]) if k in split else v)
            for k, v in state_dict.items()}


def slice_state(model, state_dict: dict) -> dict:
    """A whole ``state_dict`` cut to this rank's chunks of ``model``'s split
    parameters."""
    split = _split_params(model)
    out = {}
    for k, v in state_dict.items():
        if k in split:
            dim, tp = split[k]
            v = v.chunk(tp.size, dim)[tp.index].clone()
        out[k] = v
    return out


def _moment_names(optimizer, model) -> list:
    """The parameter name of each index of the Adam state."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for p in optimizer.params]


def gather_optimizer_state(model, optimizer, state: dict) -> dict:
    """``Optimizer.state_dict()`` with the Adam moments of split parameters
    joined whole (collective over the model axis)."""
    split = _split_params(model)
    names = _moment_names(optimizer, model)
    adam = {**state["adam"], "state": {}}
    for i, s in state["adam"]["state"].items():
        key = names[int(i)]
        if key in split:
            dim, tp = split[key]
            s = {k: (all_gather_cat(v, tp.group, dim) if k in ("exp_avg", "exp_avg_sq") else v)
                 for k, v in s.items()}
        adam["state"][i] = s
    return {**state, "adam": adam}


def slice_optimizer_state(model, optimizer, state: dict) -> dict:
    """A whole optimizer state cut to this rank's chunks."""
    split = _split_params(model)
    names = _moment_names(optimizer, model)
    adam = {**state["adam"], "state": {}}
    for i, s in state["adam"]["state"].items():
        key = names[int(i)]
        if key in split:
            dim, tp = split[key]
            s = {k: (v.chunk(tp.size, dim)[tp.index].clone()
                     if k in ("exp_avg", "exp_avg_sq") else v) for k, v in s.items()}
        adam["state"][i] = s
    return {**state, "adam": adam}
