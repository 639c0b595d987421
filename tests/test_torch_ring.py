"""The port's ring, ring-flash, Ulysses and Ulysses-flash attention and
the LM's ``_loss_for_mesh`` against the JAX package's.

The JAX side runs over an ``(sp,)`` mesh of the conftest's virtual CPU
devices (the Pallas flash kernel in interpret mode, as
``tests/test_ringattention.py`` runs it); the port's on 2 or 4 gloo ranks
(``utils.virtualcpu.RankPool``, ``torch_ranks.py``), each holding its
block of the sequence, with the flash op's plain versions on the CPU.
Inputs are numpy arrays from a seed, fp32, with grouped-query k/v (8 query
heads, 4 kv heads). Outputs and the grads of sum(out · g) in q, k and v
are held to 1e-5 (the same math in another order of sums).
"""

from functools import lru_cache, partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch_ranks as ranks
from kubeshare_tpu.models import transformer as jtrans
from kubeshare_tpu.ops.attention import dot_product_attention
from kubeshare_tpu.ops.flash_attention import flash_attention as jflash
from kubeshare_tpu.parallel import ringattention as jring
from kubeshare_tpu.parallel import ulysses as julysses
from kubeshare_tpu_torch import convert
from kubeshare_tpu_torch.models import common
from kubeshare_tpu_torch.utils.virtualcpu import RankPool

B, S, H, HK, D = 2, 16, 8, 4, 8
KINDS = ("ring", "ring_flash", "ulysses", "ulysses_flash")
LM_SMALL = dict(seq_len=16, vocab=64, dim=32, layers=1)


@pytest.fixture(scope="module")
def pools():
    with RankPool(2) as p2, RankPool(4) as p4:
        yield {2: p2, 4: p4}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, HK, D)).astype(np.float32)
    v = rng.standard_normal((B, S, HK, D)).astype(np.float32)
    g = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v, g


def _jax_attn(kind, sp, causal):
    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    if kind == "ring":
        return jring.make_ring_attention(mesh, causal=causal)
    if kind == "ring_flash":
        return jring.make_ring_flash_attention(
            mesh, causal=causal, block_q=4, block_k=4, interpret=True)
    if kind == "ulysses":
        return julysses.make_ulysses_attention(mesh, causal=causal)
    return julysses.make_ulysses_attention(
        mesh, causal=False, attn_fn=partial(
            jflash, causal=causal, block_q=4, block_k=4, interpret=True))


@lru_cache(maxsize=None)
def _jax_side(kind, sp, causal):
    q, k, v, g = _inputs()
    attn = _jax_attn(kind, sp, causal)

    def loss(q, k, v):
        return (attn(q, k, v) * g).sum()

    out = jax.jit(attn)(q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(out)] + [np.asarray(x) for x in grads]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_sequence_parallel_attention_matches_jax(pools, kind, sp, causal):
    q, k, v, g = _inputs()
    got = pools[sp].run(ranks.seq_attention, kind, sp, q, k, v, causal,
                        g)[0]
    want = _jax_side(kind, sp, causal)
    for name, a, b in zip(("out", "dq", "dk", "dv"), want, got):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=name)
    # and the exact attention of the whole sequence
    dense = np.asarray(dot_product_attention(q, k, v, causal=causal))
    np.testing.assert_allclose(got[0], dense, rtol=0, atol=1e-5)


def test_ulysses_refuses_as_jax_does(pools):
    """Heads or kv heads not divisible by sp, and a custom body with
    ``causal=True``, raise before any exchange, with JAX's messages."""
    got = pools[4].run(ranks.ulysses_refusals, 6, 2)[0]
    mesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
    want = []
    for kw in ({}, {"attn_fn": lambda q, k, v: q}):
        q = jnp.zeros((1, 16, 6, 8))
        k = jnp.zeros((1, 16, 2, 8))
        try:
            julysses.make_ulysses_attention(mesh, **kw)(q, k, k)
            want.append("")
        except ValueError as e:
            want.append(str(e))
    assert got == want and all(want)
    got = pools[4].run(ranks.ulysses_refusals, 8, 4)[0]
    assert got[0] == "" and "attn_fn supplied" in got[1]


@lru_cache(maxsize=None)
def _jax_lm():
    """The JAX LM's loss and grads on one device, fp32 (the sequence-
    parallel strategies compute the same)."""
    params = jax.tree_util.tree_map(np.asarray, jtrans.init(
        jax.random.key(5, impl="rbg"), **LM_SMALL))
    batch = common.synthetic_token_batch(6, 2, LM_SMALL["seq_len"],
                                         LM_SMALL["vocab"])
    saved = jtrans.DTYPE
    jtrans.DTYPE = jnp.float32
    try:
        loss, grads = jax.jit(jax.value_and_grad(jtrans.loss_fn))(
            params, tuple(jnp.asarray(a) for a in batch))
    finally:
        jtrans.DTYPE = saved
    return params, batch, float(loss), [
        np.asarray(x) for x in jax.tree_util.tree_leaves(grads)]


@pytest.mark.parametrize("mesh", [{"dp": 1, "sp": 2, "tp": 1},
                                  {"dp": 2, "sp": 2, "tp": 1},
                                  {"dp": 1, "sp": 2, "tp": 2}],
                         ids=["sp2", "dp2sp2", "sp2tp2"])
@pytest.mark.parametrize("kind", KINDS)
def test_lm_loss_for_mesh_matches_jax(pools, kind, mesh):
    """Each ``KUBESHARE_TPU_SP_ATTN`` strategy through the LM's mesh hooks
    (the token batch split over sp, the global positions of each block)
    gives the JAX LM's loss (1e-5 relative) and every gradient (1e-5)."""
    params, batch, jloss, jgrads = _jax_lm()
    n = int(np.prod(list(mesh.values())))
    status, loss, grads = pools[n].run(
        ranks.lm_loss_for_mesh, mesh, kind,
        convert.params_from_jax(params), batch, {})[0]
    assert status == "ok"
    assert loss == pytest.approx(jloss, rel=1e-5)
    for a, b in zip(jgrads, grads):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind,env", [
    ("rong", {}),
    ("ring", {"KUBESHARE_TPU_TRANSFORMER_WINDOW": "4"}),
    ("ring_flash", {"KUBESHARE_TPU_TRANSFORMER_WINDOW": "4"})])
def test_lm_loss_for_mesh_refuses_as_jax_does(pools, monkeypatch, kind, env):
    """A strategy typo, and a window on a ring strategy, raise JAX's
    ValueError; a mesh with no sp axis keeps the dense loss (None)."""
    params, batch, _, _ = _jax_lm()
    got = pools[2].run(ranks.lm_loss_for_mesh, {"dp": 1, "sp": 2, "tp": 1},
                       kind, convert.params_from_jax(params), batch, env)[0]
    monkeypatch.setenv("KUBESHARE_TPU_SP_ATTN", kind)
    monkeypatch.setattr(jtrans, "WINDOW", int(env.get(
        "KUBESHARE_TPU_TRANSFORMER_WINDOW", 0)) or None)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2, 1),
                ("dp", "sp", "tp"))
    with pytest.raises(ValueError) as e:
        jtrans._loss_for_mesh(mesh)
    assert got == ("error", str(e.value))
    from kubeshare_tpu_torch.models import transformer as ttrans
    from kubeshare_tpu_torch.parallel.mesh import make_mesh

    assert ttrans._loss_for_mesh(make_mesh(range(2),
                                           device_type="cpu")) is None
    assert jtrans._loss_for_mesh(Mesh(np.array(jax.devices()[:2]).reshape(
        2, 1), ("dp", "tp"))) is None
