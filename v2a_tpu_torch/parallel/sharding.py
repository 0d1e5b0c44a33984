"""Data- and tensor-parallel placement of batches and train states.

Counterpart of `v2a_tpu/parallel/sharding.py`. JAX places arrays with
NamedShardings and XLA inserts the collectives; here each rank holds its
share and the collectives are explicit `torch.distributed` calls
(`all_reduce`, `all_gather_into_tensor`, `broadcast`), which torch 2.11 and
later all have. No DTensor.

- dp: rank r of the dp axes takes rows r·B/dp … (r+1)·B/dp − 1 of the
  global batch, the order of `P('dp')` (`batch_sharding`, `shard_batch`).
- tp: `tp_leaf_spec` is the JAX rule, a wide trailing dim (>= `min_size`,
  divisible by tp) shards over 'tp', on the torch dim that holds the JAX
  layout's trailing dim: `tp_dims` reads it off the module's layers with
  the layout map of `convert/from_jax.py` (a flax Dense (in, out) is a
  Linear (out, in); the policy's convs are torch (D, C, k...) from flax
  (k..., C, D), its transposed up-conv (C_in, C_out, k); every other leaf,
  the video nets' HWIO conv kernels included, keeps the flax layout).
  `shard_train_state` gives a module's `ShardedParams`: each tp rank keeps
  the 1/tp slice of every leaf the rule shards, and the trainers keep that
  leaf's optimizer moments in the same slice. The whole parameter exists
  only from `gather()` to `release()`, around the forward and backward.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from v2a_tpu_torch.parallel.mesh import Mesh


def dp_axis_names(mesh: Mesh) -> Tuple[str, ...]:
    """Every mesh axis that carries data parallelism ('dp' and the hybrid
    'dp_dcn'/'dp_ici' pair); batches split over all of them jointly."""
    names = tuple(n for n in mesh.axis_names if str(n).startswith("dp"))
    if not names:
        raise ValueError(f"mesh {mesh.axis_names} has no dp axis")
    return names


class RowShard(NamedTuple):
    """This rank's piece of a batch split over the dp axes: piece `index` of
    `count`, its rows contiguous."""

    index: int
    count: int

    def rows(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(f"batch {n} not divisible by dp={self.count}")
        k = n // self.count
        return slice(self.index * k, (self.index + 1) * k)


def batch_sharding(mesh: Mesh, axis=None) -> RowShard:
    """The leading-dim split over `axis` (default: the mesh's dp axes)."""
    axes = dp_axis_names(mesh) if axis is None else axis
    return RowShard(mesh.index(axes), mesh.size(axes))


def shard_batch(batch: Any, mesh: Mesh, axis=None) -> Any:
    """This rank's rows of every array leaf (numpy or torch, ndim >= 1) of a
    dict / list / tuple tree, as tensors on the mesh's device; other leaves
    pass through."""
    rows = batch_sharding(mesh, axis)

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim >= 1:
            return torch.as_tensor(x[rows.rows(x.shape[0])]).to(mesh.device)
        return x

    return put(batch)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Every tensor leaf on the mesh's device with the global rank 0's
    values (a broadcast over the world), as JAX's replicated placement
    holds one value everywhere."""
    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        if isinstance(x, (np.ndarray, torch.Tensor)):
            t = torch.as_tensor(x).to(mesh.device).contiguous()
            dist.broadcast(t, src=0)
            return t
        return x

    return put(tree)


def tp_leaf_spec(x, mesh: Mesh, tp_axis: str = "tp", min_size: int = 256,
                 dim: int = -1) -> Optional[int]:
    """The dim of `x` that shards over `tp_axis`, or None (replicated): the
    JAX rule on the JAX layout's trailing dim, which is `x`'s dim `dim`
    (`tp_dims`). Applied uniformly to parameters and their optimizer
    moments (same shapes, same rule), so AdamW stays local to each shard."""
    if tp_axis not in mesh.axis_names or getattr(x, "ndim", 0) < 1:
        return None
    tp = mesh.shape[tp_axis]
    dim = dim % x.ndim
    if x.shape[dim] >= min_size and x.shape[dim] % tp == 0:
        return dim
    return None


def tp_dims(module: nn.Module) -> Dict[str, int]:
    """Per parameter name, the torch dim that holds the trailing dim of the
    JAX layout (`convert/from_jax.py`'s layout map): Linear weight 0 (flax
    Dense (in, out) transposed), Conv1d / Conv2d weight 0 (the policy's
    (k..., C, D) transposed), ConvTranspose1d weight 1 (its (k, C_in,
    C_out) as (C_in, C_out, k)); every other leaf keeps the flax layout
    (its last dim)."""
    out = {}
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            dim = p.ndim - 1
            if pname == "weight" and p.ndim >= 2:
                if isinstance(mod, nn.ConvTranspose1d):
                    dim = 1
                elif isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                    dim = 0
            out[f"{mname}.{pname}" if mname else pname] = dim
    return out


class ShardedParams:
    """One module's parameters over a mesh: dp groups average gradients,
    and each tp rank keeps `local[i]`, the 1/tp slice of every leaf `dims[i]`
    names (the parameter itself where it is None). Outside `gather()` ...
    `release()` a sharded parameter holds no memory. A tp axis of one rank
    shards nothing, so the mesh step is the single-process step there."""

    def __init__(self, module: nn.Module, mesh: Mesh, tp_axis: str = "tp",
                 min_size: int = 256):
        self.mesh = mesh
        named = list(module.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        dp = dp_axis_names(mesh)
        self.dp_group, self.dp = mesh.group(dp), mesh.size(dp)
        has_tp = tp_axis in mesh.axis_names and mesh.shape[tp_axis] > 1
        self.tp = mesh.shape[tp_axis] if has_tp else 1
        self.tp_group = mesh.group(tp_axis) if has_tp else None
        self.tp_index = mesh.index(tp_axis) if has_tp else 0
        jdims = tp_dims(module)
        self.dims: List[Optional[int]] = [
            tp_leaf_spec(p, mesh, tp_axis, min_size, jdims[n]) if has_tp else None
            for n, p in named]
        self.shapes = [tuple(p.shape) for p in self.params]
        self.local = [p if d is None else self.slice(i, p.detach()).clone()
                      for i, (p, d) in enumerate(zip(self.params, self.dims))]
        self.sharded = [i for i, d in enumerate(self.dims) if d is not None]
        self.release()

    def slice(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This tp rank's slice of leaf i's full-shaped `t` (a view)."""
        d = self.dims[i]
        if d is None:
            return t
        k = t.shape[d] // self.tp
        return t.narrow(d, self.tp_index * k, k)

    def full(self, i: int, local: torch.Tensor) -> torch.Tensor:
        """Leaf i's whole tensor from every tp rank's slice (collective)."""
        d = self.dims[i]
        if d is None:
            return local
        x = local.movedim(d, 0).contiguous()  # the slices are blocks along d
        out = torch.empty((self.tp * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x, group=self.tp_group)
        return out.movedim(0, d).contiguous()

    @torch.no_grad()
    def gather(self) -> None:
        """Every sharded parameter whole again, from the ranks' slices."""
        for i in self.sharded:
            self.params[i].data = self.full(i, self.local[i])

    @torch.no_grad()
    def release(self) -> None:
        for i in self.sharded:
            p = self.params[i]
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    @contextlib.contextmanager
    def whole(self, write_back: bool = False):
        """The module with whole parameters inside the block; with
        `write_back`, values loaded into them meanwhile become the slices."""
        self.gather()
        try:
            yield
            if write_back:
                with torch.no_grad():
                    for i in self.sharded:
                        self.local[i].copy_(self.slice(i, self.params[i].detach()))
        finally:
            self.release()

    def dp_mean(self, ts: Sequence[torch.Tensor]) -> None:
        """In place: the mean over the dp group (sum, then / dp)."""
        works = [dist.all_reduce(t, group=self.dp_group, async_op=True) for t in ts]
        for w in works:
            w.wait()
        if self.dp > 1:
            torch._foreach_div_(list(ts), float(self.dp))

    def local_grads(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Whole-parameter gradients of this rank's rows -> the dp mean,
        sliced to what this rank keeps."""
        grads = list(grads)
        self.dp_mean(grads)
        return [g if self.dims[i] is None else self.slice(i, g).clone()
                for i, g in enumerate(grads)]

    def tp_sum(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        """Per leaf scalars: a sharded leaf's value summed over the tp group
        (one all-reduce), a replicated one counted once."""
        if not self.sharded:
            return values
        s = torch.stack([values[i] for i in self.sharded])
        dist.all_reduce(s, group=self.tp_group)
        out = list(values)
        for j, i in enumerate(self.sharded):
            out[i] = s[j]
        return out


def shard_train_state(module: nn.Module, mesh: Mesh, tp_axis: str = "tp",
                      min_size: int = 256) -> ShardedParams:
    """A trained module's parameters on the mesh: wide leaves sharded over
    `tp_axis` (the rule above), the rest replicated. With no 'tp' axis this
    is pure dp."""
    return ShardedParams(module, mesh, tp_axis, min_size)


def all_gather_rows(t: torch.Tensor, mesh: Mesh, axis=None) -> torch.Tensor:
    """The dp ranks' row blocks of one batch, concatenated in rank order:
    the global batch on every rank."""
    axes = dp_axis_names(mesh) if axis is None else axis
    n = mesh.size(axes)
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=mesh.group(axes))
    return out
