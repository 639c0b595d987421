"""The collectives of the port's SPMD code, each differentiable, and the
local view a sharded step gives the model code it runs.

The JAX package writes its parallel code as global arrays under
``shard_map`` and ``jit``, and XLA inserts and transposes the collectives.
The port runs one process per device, each holding its shard, so the
collectives are explicit ``torch.distributed`` calls; each is a
``torch.autograd.Function`` whose backward is the JAX transpose:

- :func:`ring_shift` — ``lax.ppermute`` one hop round a ring; backward
  shifts the other way;
- :func:`all_to_all` — ``lax.all_to_all``; backward is the inverse
  exchange;
- :func:`psum` — ``lax.psum`` with a replicated output, consumed as
  such (the pipeline's last-stage outputs): backward passes the
  cotangent through;
- :func:`global_sum` — a psum whose result feeds per-rank values again
  (batchnorm's statistics under data parallelism): backward sums the
  cotangents too, as JAX's ``psum`` followed by its implicit ``pvary``
  transposes;
- :func:`all_gather` — a shard gathered where it is used; the ranks that
  gather it compute the same thing, so backward takes this rank's slice.

Every rank holds its own loss: the global loss is the SUM of the ranks'
losses over the axes that split the batch, and the same loss on every
rank of an axis that does not (tensor parallelism). A rank's backward
then gives its share of the global gradient, which the step sums over
the batch axes.

Gloo takes CUDA tensors for few of these ops, so where a group's backend
is gloo a CUDA tensor is staged through host memory (a copy each way);
NCCL takes them where they lie. Data-movement ops (shift, all-to-all,
gather) move the raw bytes, so they carry any dtype; sums run in the
tensor's own dtype.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

import torch
import torch.distributed as dist


# --- mesh axes -------------------------------------------------------------------

def axis_size(mesh, name: str) -> int:
    """Size of the mesh axis ``name``."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate on the mesh axis ``name``."""
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(name)]


def axis_group(mesh, name: str):
    """The process group of the mesh axis ``name`` through this rank."""
    return mesh.get_group(name)


# --- the local view of a sharded step --------------------------------------------

@dataclass(frozen=True)
class LocalView:
    """What a rank holds of the global arrays inside a sharded step:
    ``batch_axes`` are the mesh axes (of size > 1) over which the data is
    split, so a statistic over the batch sums over them; ``seq_offset`` is
    the global position of this rank's first token when the sequence is
    split over ``sp`` (0 otherwise)."""
    mesh: object
    batch_axes: tuple[str, ...] = ()
    seq_offset: int = 0


_VIEW: contextvars.ContextVar = contextvars.ContextVar("kubeshare_view",
                                                       default=None)


def current_view() -> LocalView | None:
    """The view of the sharded step running on this thread, or None."""
    return _VIEW.get()


@contextlib.contextmanager
def local_view(view: LocalView):
    token = _VIEW.set(view)
    try:
        yield view
    finally:
        _VIEW.reset(token)


def seq_offset() -> int:
    """Global position of this rank's first token (0 outside a sequence-
    split step): the position table and RoPE read from here."""
    view = _VIEW.get()
    return 0 if view is None else view.seq_offset


def batch_split() -> tuple[str, ...]:
    """The mesh axes that split the batch in the running step."""
    view = _VIEW.get()
    return () if view is None else view.batch_axes


# --- staging -------------------------------------------------------------------

def _gloo(group) -> bool:
    return dist.get_backend(group) == dist.Backend.GLOO


def _to_wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` where the group's backend takes it: a host copy of a CUDA
    tensor under gloo, else ``x`` itself."""
    return x.cpu() if x.is_cuda and _gloo(group) else x


def _as_bytes(ts) -> torch.Tensor:
    """The tensors' bytes, packed into one flat uint8 buffer."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in ts])


def _from_bytes(buf: torch.Tensor, likes, device) -> list[torch.Tensor]:
    """Split a packed buffer back into tensors shaped as ``likes``."""
    out, at = [], 0
    buf = buf.to(device)
    for t in likes:
        n = t.numel() * t.element_size()
        chunk = buf[at:at + n]
        if len(likes) > 1:
            # a tensor of its own (aligned for its dtype), not a view
            # into one buffer that several outputs share
            chunk = chunk.clone()
        out.append(chunk.view(t.dtype).reshape(t.shape))
        at += n
    return out


def _peer(group, offset: int) -> int:
    """Global rank of the group member ``offset`` places round the ring."""
    me = dist.get_rank(group)
    return dist.get_global_rank(group, (me + offset) % dist.get_world_size(group))


def _shift(ts, group, offset: int) -> list[torch.Tensor]:
    """Send the tensors to the member ``offset`` ahead and receive the ones
    the member ``offset`` behind sends: one packed message each way."""
    send = _to_wire(_as_bytes(ts), group)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, _peer(group, offset), group),
           dist.P2POp(dist.irecv, recv, _peer(group, -offset), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return _from_bytes(recv, ts, ts[0].device)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, offset, *ts):
        ctx.group, ctx.offset = group, offset
        return tuple(_shift(ts, group, offset))

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros_like(g) if g is None else g for g in grads]
        return (None, None, *_shift(grads, ctx.group, -ctx.offset))


def ring_shift(ts, group, offset: int = 1) -> tuple[torch.Tensor, ...]:
    """``lax.ppermute`` with the permutation ``j → j + offset`` round the
    group: every rank sends ``ts`` ahead and gets the ones from behind.

    Every rank must run the backward of every shift, or a peer waits for
    its message for ever: a rank whose result of a shift goes unused
    (the ring's future tile, the pipeline's first stage) passes it to
    :func:`anchor`."""
    ts = tuple(ts)
    if dist.get_world_size(group) == 1:
        return ts
    return _RingShift.apply(group, offset, *ts)


class _Anchor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *ts):
        ctx.likes = [(t.shape, t.dtype, t.device) for t in ts]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dev)
                     for s, d, dev in ctx.likes))


def anchor(x: torch.Tensor, *ts) -> torch.Tensor:
    """``x`` itself, with the tensors ``ts`` in its history: the backward
    reaches their producers (with zero cotangents), so a collective's
    backward runs on this rank even where its result is not used."""
    ts = [t for t in ts if t.requires_grad]
    if not ts or not torch.is_grad_enabled():
        return x
    return _Anchor.apply(x, *ts)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` over the leading axis (one chunk a member),
    moving bytes."""
    n = dist.get_world_size(group)
    flat = _to_wire(x.contiguous().view(n, -1).view(torch.uint8), group)
    out = torch.empty_like(flat)
    dist.all_to_all_single(out, flat, group=group)
    return out.to(x.device).view(x.dtype).view(x.shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of leading axis = the group size: chunk ``j`` goes to member
    ``j``, and the result's chunk ``j`` came from member ``j``."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllToAll.apply(x, group)


def _reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = _to_wire(x.contiguous(), group)
    if y is x:
        y = x.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.device)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, reduce_grad):
        ctx.group, ctx.reduce_grad = group, reduce_grad
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return (_reduce(g, ctx.group) if ctx.reduce_grad else g), None, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, the result consumed as a replicated value
    (backward: the cotangent as it is)."""
    if dist.get_world_size(group) == 1:
        return x
    return _Psum.apply(x, group, False)


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group of a partial statistic whose result feeds each
    rank's own values again (backward: the cotangents summed too)."""
    if dist.get_world_size(group) == 1:
        return x
    return _Psum.apply(x, group, True)


def sum_over_axes(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """:func:`global_sum` over several mesh axes, one after the other."""
    for name in axes:
        x = global_sum(x, axis_group(mesh, name))
    return x


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over the group, outside autograd (gradients, losses)."""
    if dist.get_world_size(group) > 1:
        x.copy_(_reduce(x, group))
    return x


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    flat = _to_wire(x.contiguous().reshape(-1).view(torch.uint8), group)
    out = torch.empty(n * flat.numel(), dtype=torch.uint8,
                      device=flat.device)
    dist.all_gather_into_tensor(out, flat, group=group)
    parts = out.to(x.device).view(x.dtype).view(n, *x.shape).unbind(0)
    return torch.cat(parts, dim=dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.index = dim, dist.get_rank(group)
        ctx.size = x.shape[dim]
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The members' shards concatenated along ``dim`` in member order, for
    a computation every member makes alike (backward: this rank's
    slice of the cotangent)."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllGather.apply(x, dim, group)
