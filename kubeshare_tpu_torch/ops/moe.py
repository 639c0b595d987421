"""Mixture-of-experts FFN: top-1 routing with the dense capacity-based
dispatch (Mesh-TensorFlow / Switch style).

Counterpart of ``kubeshare_tpu/ops/moe.py``'s ``moe_init`` and
``moe_apply``, step for step: the same groups, capacity, cumsum
positions, overflow drop, casts and aux loss, so a parameter tree and its
outputs cross between the packages. Routing, dispatch and combine are
einsums over one-hot tensors (static shapes, no gather or scatter); the
JAX package leaves them to XLA outside any Pallas kernel, and here they
are ``torch.einsum`` (cuBLAS on the card). Over-capacity tokens are
dropped: their FFN output is zero, and the block's residual carries them.

``expert_sharding`` lays the expert stacks over an ``ep`` mesh axis.
Under a sharded step whose batch is split (dp, dcn or sp of size > 1)
``moe_apply`` raises: JAX routes over the GLOBAL batch's groups, which
a rank holding part of the batch cannot (ROADMAP queue 3).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def moe_init(rng: np.random.Generator, dim: int, hidden: int,
             n_experts: int) -> dict:
    scale_in = math.sqrt(1.0 / dim)
    scale_hid = math.sqrt(1.0 / hidden)
    uniform = lambda scale, shape: rng.uniform(-scale, scale, shape).astype(
        np.float32)
    return {"router": uniform(scale_in, (dim, n_experts)),
            "fc": uniform(scale_in, (n_experts, dim, hidden)),
            "proj": uniform(scale_hid, (n_experts, hidden, dim))}


def _combine(dispatch: torch.Tensor, gate: torch.Tensor,
             expert_out: torch.Tensor) -> torch.Tensor:
    """The experts' outputs back in token order, each scaled by its gate:
    the combine weights are built in fp32 and cast to ``expert_out``'s
    dtype, so in bf16 the gate rounds here, where the JAX package rounds
    it."""
    combine = dispatch * gate[..., None, None]
    return torch.einsum("gmec,gecd->gmd", combine.to(expert_out.dtype),
                        expert_out)


def moe_apply(params: dict, x: torch.Tensor, capacity_factor: float = 1.25,
              group_size: int = 2048, dtype=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-1 routed MoE FFN. ``x`` (batch, seq, dim) → (the same shape,
    aux loss).

    Tokens are routed within groups of at most ``group_size`` with a
    per-group capacity of ``max(1, int(capacity_factor * m / E))`` slots
    an expert; the dispatch tensor is (g, m, E, C). The router runs in
    fp32; ``x`` and the expert stacks are cast to ``dtype``; the combine
    weights are built in fp32 and cast to the experts' output dtype (the
    gate rounds there). ``aux`` is the Switch load-balancing loss from the
    assignment before the capacity drop, so a collapsed router scores
    about E. Gradients reach the router through the gate probabilities
    and the aux loss only: the argmax, one-hots and cumsum carry none, as
    under ``jax.grad``."""
    from ..parallel.collectives import batch_split

    split = batch_split()
    if split:
        raise NotImplementedError(
            f"the mixture of experts under a mesh that splits the batch "
            f"over {split}: the JAX package routes, drops and balances "
            f"over the global batch's groups, which a rank holding part "
            f"of the batch cannot; use a mesh with dp = sp = 1 (ROADMAP "
            f"queue 3, 'MoE under a batch-splitting mesh')")
    b, s, d = x.shape
    n = b * s
    e = params["router"].shape[1]
    # the fewest groups that tile the tokens exactly: the smallest divisor
    # g of n with n // g <= group_size
    g = next(g for g in range(max(1, -(-n // group_size)), n + 1)
             if n % g == 0)
    m = n // g
    cap = max(1, int(capacity_factor * m / e))
    router, fc, proj = params["router"], params["fc"], params["proj"]
    if dtype is not None:
        x, fc, proj = x.to(dtype), fc.to(dtype), proj.to(dtype)

    tokens = x.reshape(g, m, d)
    # router in fp32: a tiny matmul, and softmax/argmax in bf16 misroute
    logits = torch.einsum("gmd,de->gme", tokens.float(), router)
    probs = torch.softmax(logits, dim=-1)
    expert = probs.argmax(dim=-1)                     # (g, m), first on ties
    gate = probs.gather(-1, expert[..., None])[..., 0]

    assigned = F.one_hot(expert, e).float()           # (g, m, E)
    # each token's place in its expert's buffer for the group
    pos = (assigned.cumsum(dim=1) - 1.0) * assigned
    onehot = assigned * (pos < cap)                   # drop the overflow
    # one-hot of the slot; a slot past the capacity has none, as
    # jax.nn.one_hot gives for an index out of range
    slot = pos.sum(dim=-1).long()
    posoh = (slot[..., None] == torch.arange(cap, device=x.device)).float()
    dispatch = onehot[..., None] * posoh[:, :, None, :]   # (g, m, E, C)

    expert_in = torch.einsum("gmec,gmd->gecd", dispatch.to(tokens.dtype),
                             tokens)
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(torch.einsum("gecd,edh->gech", expert_in, fc),
               approximate="tanh")
    expert_out = torch.einsum("gech,ehd->gecd", h, proj)   # (g, E, C, d)
    out = _combine(dispatch, gate, expert_out)

    # Switch aux loss from the assignment before the drop, in fp32
    frac_tokens = assigned.mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = (frac_tokens * frac_probs).sum() * e
    return out.reshape(b, s, d), aux


def expert_sharding(mesh, params: dict) -> dict:
    """The expert stacks' leading E axis over ``ep`` (the router
    replicated), as placements: the layout of ``kubeshare_tpu``'s
    ``expert_sharding``. A sharded step gathers each stack where the
    experts use it. Raises without an ``ep`` axis."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    if "ep" not in names:
        raise ValueError(f"mesh {names} has no 'ep' axis")
    stack = tuple(Shard(0) if n == "ep" else Replicate() for n in names)
    return {"router": tuple(Replicate() for _ in names),
            "fc": stack, "proj": stack}
