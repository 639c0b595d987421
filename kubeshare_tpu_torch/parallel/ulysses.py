"""All-to-all (Ulysses-style) sequence parallelism over an ``sp`` axis.

Counterpart of ``kubeshare_tpu/parallel/ulysses.py``, the second of the
two long-context strategies beside :mod:`.ringattention`: two all-to-all
exchanges trade heads for sequence, so each rank attends over the FULL
sequence for ``heads/sp`` of the heads, entirely locally, and the output
is exchanged back. Needs ``heads`` and ``kv_heads`` divisible by ``sp``.
The local attention body is pluggable (dense by default; the flash
kernel for long sequences).

The body runs on this rank's shard, (batch, block, heads, head_dim), the
exchange over the mesh axis ``axis_name`` of the running sharded step
(or of ``mesh``). q, k and v cross in ONE exchange (packed by head
group) and the output in another, each a differentiable all-to-all whose
backward is the inverse exchange.
"""

from __future__ import annotations

from functools import partial

import torch

from ..ops.attention import dot_product_attention
from .collectives import all_to_all
from .ringattention import _ring, _seq_shard_spec


def _seq_to_heads(xs, sp: int, group):
    """(b, s/sp, h_i, d) tensors → (b, s, h_i/sp, d): each rank keeps
    head chunk ``me`` of every rank's block, in sequence order."""
    b, s_loc = xs[0].shape[:2]
    d = xs[0].shape[-1]
    split = [x.reshape(b, s_loc, sp, x.shape[2] // sp, d) for x in xs]
    packed = torch.cat(split, dim=3).permute(2, 0, 1, 3, 4)
    got = all_to_all(packed, group)                  # (sp, b, s/sp, ., d)
    got = got.permute(1, 0, 2, 3, 4).reshape(b, sp * s_loc, -1, d)
    sizes = [x.shape[2] // sp for x in xs]
    return got.split(sizes, dim=2)


def _heads_to_seq(o: torch.Tensor, sp: int, group) -> torch.Tensor:
    """(b, s, h/sp, d) → (b, s/sp, h, d): each rank gets its sequence
    block with every rank's heads, in rank order."""
    b, s, hl, d = o.shape
    chunks = o.reshape(b, sp, s // sp, hl, d).permute(1, 0, 2, 3, 4)
    got = all_to_all(chunks, group)                  # (sp, b, s/sp, h/sp, d)
    return got.permute(1, 2, 0, 3, 4).reshape(b, s // sp, sp * hl, d)


def ulysses_attention_shard(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, axis_name: str,
                            causal: bool = True, attn_fn=None, *, mesh=None
                            ) -> torch.Tensor:
    """This rank's queries' attention output over the full sequence,
    (batch, block, heads, head_dim) fp32."""
    sp, _, group = _ring(axis_name, mesh)
    h, hk = q.shape[2], k.shape[2]
    if h % sp or hk % sp:
        raise ValueError(
            f"ulysses needs heads ({h}) AND kv_heads ({hk}) divisible "
            f"by sp ({sp}); use ring attention for this shape")
    if attn_fn is not None and causal:
        # a custom body owns all the attention math, masking included
        raise ValueError(
            "attn_fn supplied: causal masking is the attn_fn's job — "
            "pass causal=False and bake the mask into attn_fn (e.g. "
            "partial(flash_attention, causal=True))")
    attn = attn_fn or partial(dot_product_attention, causal=causal)
    if sp == 1:
        return attn(q, k, v)
    o = attn(*_seq_to_heads((q, k, v), sp, group))
    return _heads_to_seq(o, sp, group)


def make_ulysses_attention(mesh, causal: bool = True, axis_name: str = "sp",
                           attn_fn=None):
    """An ``attn_fn(q, k, v)`` over this rank's sequence block, the
    all-to-all twin of :func:`.ringattention.make_ring_attention` (same
    signature; plug into :func:`kubeshare_tpu_torch.ops.attention.
    mha_apply`). For long sequences pass the flash kernel as the local
    body::

        make_ulysses_attention(mesh, causal=False,
                               attn_fn=partial(flash_attention, causal=True))
    """
    _seq_shard_spec(mesh, axis_name)

    def attn(q, k, v):
        return ulysses_attention_shard(q, k, v, axis_name, causal=causal,
                                       attn_fn=attn_fn, mesh=mesh)

    return attn
