"""Ring attention: sequence-parallel exact attention over an ``sp`` mesh
axis.

Counterpart of ``kubeshare_tpu/parallel/ringattention.py``. Each rank
holds one contiguous block of the sequence; key/value blocks travel round
the ring (one hop a step, :func:`~.collectives.ring_shift`, whose
backward shifts the other way) while queries stay put, and the partial
results merge exactly — so attention over the FULL sequence is exact, and
no rank ever holds more than a (block × block) score tile.

Where JAX writes the body for ``shard_map``, the port's runs on this
rank's shard: ``q``/``k``/``v`` are (batch, block, heads, head_dim), the
rank's block of the sequence. The ring's group is the mesh axis
``axis_name`` of the sharded step running (its local view), or of the
``mesh`` given. ``lax.switch`` over the step's tile becomes a host
branch: the rank and the step are known on the host.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import Replicate, Shard

from ..ops.attention import MASK_VALUE, expand_kv, kv_groups
from .collectives import (anchor, axis_group, axis_index, axis_size,
                          current_view, ring_shift)


def _ring(axis_name: str, mesh=None):
    """``(size, index, group)`` of the ring over ``axis_name``: of
    ``mesh``, or of the running sharded step's mesh."""
    if mesh is None:
        view = current_view()
        if view is None:
            raise ValueError(
                f"no mesh for axis {axis_name!r}: run inside a sharded "
                f"step (parallel.mesh.make_sharded_train_step) or pass "
                f"mesh=")
        mesh = view.mesh
    if axis_name not in mesh.mesh_dim_names:
        raise ValueError(f"mesh {tuple(mesh.mesh_dim_names)} has no "
                         f"{axis_name!r} axis")
    n = axis_size(mesh, axis_name)
    if n == 1:
        return 1, 0, None
    return n, axis_index(mesh, axis_name), axis_group(mesh, axis_name)


def _full(like: torch.Tensor, shape, value: float) -> torch.Tensor:
    return torch.full(shape, value, dtype=torch.float32, device=like.device)


def ring_attention_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         axis_name: str, causal: bool = True,
                         scale: float | None = None, *, mesh=None
                         ) -> torch.Tensor:
    """This rank's queries against the FULL sequence, the dense score
    tile per ring step: (batch, block, heads, head_dim) fp32. Grouped-
    query k/v expand only at the local product, so what rides the ring
    stays kv-sized."""
    sp, me, group = _ring(axis_name, mesh)
    b, nq, h, d = q.shape
    if h != k.shape[2]:
        kv_groups(h, k.shape[2])
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    qf = q.float()
    o = _full(q, (b, nq, h, d), 0.0)
    m = _full(q, (b, nq, h), MASK_VALUE)
    l = _full(q, (b, nq, h), 0.0)
    kblk, vblk = k, v
    mask_value = torch.tensor(MASK_VALUE, device=q.device)
    for i in range(sp):
        src = (me - i) % sp                 # the global block held now
        kb, vb = expand_kv(kblk, vblk, h)
        scores = torch.einsum("bqhd,bkhd->bqhk", qf, kb.float()) * scale
        if causal:
            qidx = me * nq + torch.arange(nq, device=q.device)
            kidx = src * nq + torch.arange(nq, device=q.device)
            mask = qidx[:, None] >= kidx[None, :]
            scores = torch.where(mask[None, :, None, :], scores, mask_value)
        # online softmax; a fully masked row keeps m at the floor, and the
        # guards turn its exp(0) = 1 into 0
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.where(m > MASK_VALUE * 0.5, torch.exp(m - m_new),
                            0.0)
        p = torch.where(scores > MASK_VALUE * 0.5,
                        torch.exp(scores - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        o = (o * alpha[..., None]
             + torch.einsum("bqhk,bkhd->bqhd", p, vb.float()))
        m = m_new
        if i < sp - 1:
            kblk, vblk = ring_shift((kblk, vblk), group)
    return o / torch.where(l > 0.0, l, 1.0)[..., None]


def _merge(o, lse, o_i, lse_i):
    """Exact merge of two normalized partials over disjoint key sets; a
    masked partial (lse at the floor) weighs exactly 0."""
    lse_new = torch.logaddexp(lse, lse_i)
    wa = torch.where(lse > MASK_VALUE * 0.5, torch.exp(lse - lse_new), 0.0)
    wb = torch.where(lse_i > MASK_VALUE * 0.5, torch.exp(lse_i - lse_new),
                     0.0)
    return o * wa[..., None] + o_i * wb[..., None], lse_new


def ring_flash_attention_shard(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, axis_name: str,
                               causal: bool = True,
                               block_q: int | None = None,
                               block_k: int | None = None, *, mesh=None
                               ) -> torch.Tensor:
    """Ring attention whose tile is the flash kernel
    (:func:`~kubeshare_tpu_torch.ops.flash_attention.flash_attention_lse`),
    the partials merged through their logsumexp, so the backward kernels
    get a nonzero lse cotangent. Causally, ring step i holds global block
    (me − i) mod sp, which is entirely past (a non-causal launch), the
    diagonal (a causal launch) or entirely future (no launch: zeros at
    the mask floor)."""
    from ..ops.flash_attention import BLOCK_K, BLOCK_Q, flash_attention_lse

    sp, me, group = _ring(axis_name, mesh)
    b, nq, h, d = q.shape
    bq = min(BLOCK_Q, nq) if block_q is None else block_q
    bk = min(BLOCK_K, nq) if block_k is None else block_k
    o = _full(q, (b, nq, h, d), 0.0)
    lse = _full(q, (b, nq, h), MASK_VALUE)
    kblk, vblk = k, v
    for i in range(sp):
        src = (me - i) % sp
        if causal and src > me:
            # a future block: no launch; the blocks still take part in
            # the backward, whose ring shifts every rank must join
            o_i = _full(q, (b, nq, h, d), 0.0)
            lse_i = anchor(_full(q, (b, nq, h), MASK_VALUE), kblk, vblk)
        else:
            o_i, lse_i = flash_attention_lse(
                q, kblk, vblk, causal=causal and src == me, block_q=bq,
                block_k=bk)
        o, lse = _merge(o, lse, o_i, lse_i)
        if i < sp - 1:
            kblk, vblk = ring_shift((kblk, vblk), group)
    return o


def _seq_shard_spec(mesh, axis_name: str) -> tuple:
    """The sequence-parallel layout of the global (batch, seq, heads,
    head_dim) arrays, as placements: batch over ``dp``, sequence over the
    ring axis, heads over ``tp``. Inside the port's sharded step a rank
    holds every head (the ranks of ``tp`` compute alike), so only the
    ring axis splits what the attention sees."""
    names = tuple(mesh.mesh_dim_names)
    if axis_name not in names:
        raise ValueError(f"mesh {names} has no {axis_name!r} axis")
    return tuple(Shard(0) if n == "dp" else Shard(1) if n == axis_name
                 else Shard(2) if n == "tp" else Replicate() for n in names)


def make_ring_attention(mesh, causal: bool = True, axis_name: str = "sp"):
    """An ``attn_fn(q, k, v)`` over this rank's sequence block, the ring
    over ``axis_name`` of ``mesh``; plug it into
    :func:`kubeshare_tpu_torch.ops.attention.mha_apply`."""
    _seq_shard_spec(mesh, axis_name)

    def attn(q, k, v):
        return ring_attention_shard(q, k, v, axis_name, causal=causal,
                                    mesh=mesh)

    return attn


def make_ring_flash_attention(mesh, causal: bool = True,
                              axis_name: str = "sp",
                              block_q: int | None = None,
                              block_k: int | None = None):
    """:func:`make_ring_attention` with the flash kernels as the tile of
    each ring step (:func:`ring_flash_attention_shard`) — the
    long-context configuration."""
    _seq_shard_spec(mesh, axis_name)

    def attn(q, k, v):
        return ring_flash_attention_shard(q, k, v, axis_name, causal=causal,
                                          block_q=block_q, block_k=block_k,
                                          mesh=mesh)

    return attn
