"""What a loaded program may cost the proxy, repaired: an index out of
range and a factory op with no device (``isolation/exported.py``).

An index out of range in a loaded graph gives what the JAX package gives
for it — a read clamps (``x[i]``) or fills (``take_along_axis``), an
update drops it — instead of a device-side assert that would end the
proxy's CUDA context for every tenant (the card case is in
``test_torch_cuda.py``); the full train step of the LM with an
out-of-range token goes against the JAX package's step. A factory op that
names no device is given the proxy's, so its tensor is charged.
"""

import io
import json
import zipfile
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeshare_tpu.models import transformer as jtrans
from kubeshare_tpu.models.common import make_train_step as jax_train_step
from kubeshare_tpu.ops.fused_adam import fused_adam as jax_fused_adam
from kubeshare_tpu_torch import convert
from kubeshare_tpu_torch.isolation import exported
from kubeshare_tpu_torch.isolation.client import ProxyClient
from kubeshare_tpu_torch.isolation.proxy import ChipProxy
from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler
from kubeshare_tpu_torch.models import common
from kubeshare_tpu_torch.models import transformer as ttrans
from kubeshare_tpu_torch.ops.fused_adam import fused_adam
from kubeshare_tpu_torch.utils.tree import tree_leaves

LR = 1e-3
SMALL_LM = dict(seq_len=32, vocab=64, dim=64, layers=2)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the suite runs in parallel workers: keep torch's CPU kernels from
    # taking every core from the timing-sensitive tests of other workers
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def proxy():
    p = ChipProxy(device="cpu", scheduler=TokenScheduler(1000.0, 100.0,
                                                         10.0))
    p.serve()
    yield p
    p.close()


def _load(fn, *args):
    blob, *_ = exported.export_program(fn, args, "cpu")
    return exported.load_program(blob, "cpu")


# --- each guarded op against the JAX op ------------------------------------------

TABLE = np.arange(20, dtype=np.float32).reshape(5, 4)
IDS = np.array([0, 4, 5, 9, -1, -5, -6, -20, 2])


def test_a_read_clamps_as_jax_indexing_does():
    got = _load(lambda t, i: t[i], torch.zeros(5, 4),
                torch.zeros(9, dtype=torch.int64))(
        torch.from_numpy(TABLE), torch.from_numpy(IDS))[0]
    want = np.asarray(jnp.asarray(TABLE)[jnp.asarray(IDS)])
    np.testing.assert_array_equal(got.numpy(), want)
    # the embedding op and index_select take the same rule
    emb = _load(lambda t, i: torch.nn.functional.embedding(i, t),
                torch.zeros(5, 4), torch.zeros(9, dtype=torch.int64))
    np.testing.assert_array_equal(
        emb(torch.from_numpy(TABLE), torch.from_numpy(IDS))[0].numpy(), want)
    sel = _load(lambda t, i: torch.index_select(t, 0, i), torch.zeros(5, 4),
                torch.zeros(9, dtype=torch.int64))
    np.testing.assert_array_equal(
        sel(torch.from_numpy(TABLE), torch.from_numpy(IDS))[0].numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8])
def test_gather_fills_as_take_along_axis_does(dtype):
    ids = np.array([[3], [-1], [4], [-5], [9], [0]])
    table = np.arange(24).reshape(6, 4).astype(dtype)
    prog = _load(lambda t, i: torch.gather(t, -1, i),
                 torch.zeros(6, 4, dtype=torch.from_numpy(table).dtype),
                 torch.zeros(6, 1, dtype=torch.int64))
    got = prog(torch.from_numpy(table), torch.from_numpy(ids))[0].numpy()
    want = np.asarray(jnp.take_along_axis(jnp.asarray(table),
                                          jnp.asarray(ids), axis=-1))
    np.testing.assert_array_equal(got, want)


def test_updates_drop_as_jax_scatters_do():
    """``index_put`` (accumulating, the gradient of a read), ``index_add``
    and ``scatter_add`` drop an out-of-range element; an overwriting
    ``scatter`` leaves its target as it was."""
    vals = np.arange(1, 10, dtype=np.float32)
    want = np.asarray(jnp.zeros(5).at[jnp.asarray(IDS)].add(vals))
    for fn in (lambda z, i, v: torch.index_put(z, (i,), v, accumulate=True),
               lambda z, i, v: z.index_add(0, i, v),
               lambda z, i, v: z.scatter_add(0, i, v)):
        prog = _load(fn, torch.zeros(5), torch.zeros(9, dtype=torch.int64),
                     torch.zeros(9))
        got = prog(torch.zeros(5), torch.from_numpy(IDS),
                   torch.from_numpy(vals))[0]
        np.testing.assert_array_equal(got.numpy(), want)
    ids = np.array([9, 1, -1])       # distinct in-range targets
    base = np.arange(5, dtype=np.float32)
    prog = _load(lambda z, i, v: z.scatter(0, i, v), torch.zeros(5),
                 torch.zeros(3, dtype=torch.int64), torch.zeros(3))
    got = prog(torch.from_numpy(base), torch.from_numpy(ids),
               torch.tensor([7.0, 8.0, 9.0]))[0]
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnp.asarray(base).at[jnp.asarray(ids)].set(
            jnp.asarray([7.0, 8.0, 9.0]))))


def test_gradients_through_a_guarded_read_drop_as_jax_does():
    ids = np.array([5, -1, -7, 1])

    def f(t, i):
        return (t[i] * torch.arange(1.0, 5.0)).sum()

    def grad_fn(t, i):
        t = t.detach().requires_grad_(True)
        return torch.autograd.grad(f(t, i), t)

    got = _load(grad_fn, torch.zeros(3, 4),
                torch.zeros(4, dtype=torch.int64))(
        torch.arange(12.0).reshape(3, 4), torch.from_numpy(ids))[0]
    want = jax.grad(lambda a, i: jnp.sum(a[i] * jnp.arange(1.0, 5.0)))(
        jnp.arange(12.0).reshape(3, 4), jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nll_loss_fills_an_out_of_range_target_and_drops_its_gradient():
    logits = torch.randn(4, 5, generator=torch.Generator().manual_seed(0))

    def step(x, t):
        x = x.detach().requires_grad_(True)
        per = torch.nn.functional.cross_entropy(x, t, reduction="none")
        loss = torch.nn.functional.cross_entropy(x, t)
        return (per, loss) + torch.autograd.grad(loss, x)

    prog = _load(step, torch.zeros(4, 5), torch.zeros(4, dtype=torch.int64))
    per, loss, grad = prog(logits, torch.tensor([1, 7, -100, 4]))
    assert torch.isnan(per[1]) and torch.isnan(loss)
    assert per[2] == 0.0 and torch.isfinite(grad).all()
    assert (grad[1] == 0).all() and (grad[2] == 0).all()


def test_an_index_in_range_runs_unchanged_bit_for_bit():
    t = torch.randn(7, 3, generator=torch.Generator().manual_seed(2))
    i = torch.tensor([[0, 6], [3, -2]])

    def fn(t, i):
        t = t.detach().requires_grad_(True)
        y = t[i].sum(-1) * 1.5
        g = torch.gather(t, 0, i.abs()[:, :1].expand(2, 3))
        return (y, g) + torch.autograd.grad((y.sum() + g.sum()), t)

    got = _load(fn, torch.zeros(7, 3), torch.zeros(2, 2,
                                                    dtype=torch.int64))(t, i)
    for a, b in zip(got, fn(t, i)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fn", [
    lambda t, i: torch.take(t, i),
    lambda t, i: t.index_fill(0, i, 1.0),
    lambda t, i: t.index_copy(0, i, t[:3].clone()),
    lambda t, i: t.scatter_reduce(0, i.unsqueeze(-1).expand(3, 4), t[:3],
                                  "amax"),
], ids=["take", "index_fill", "index_copy", "scatter_reduce"])
def test_index_ops_without_a_guard_are_refused(fn):
    blob, *_ = exported.export_program(
        fn, (torch.zeros(5, 4), torch.zeros(3, dtype=torch.int64)), "cpu")
    with pytest.raises(exported.ProgramRefused, match="not allowed"):
        exported.load_program(blob, "cpu")


# --- the train step ------------------------------------------------------------

@pytest.mark.parametrize("where", ["token", "target", "negative"])
def test_an_out_of_range_token_id_gives_the_jax_step(proxy, where):
    """The LM's loaded train step with an out-of-range token id against the
    JAX package's step on the same id (with its dense attention): the
    embedding clamps, the loss of an out-of-range target is
    NaN as ``take_along_axis`` fills, and the gradients drop what either
    read took out of range — params after the step to the tolerances of
    ``test_transformer_flash_through_proxy_attach_matches_jax``."""
    vocab = SMALL_LM["vocab"]
    params = jax.tree_util.tree_map(
        np.asarray, jtrans.init(jax.random.PRNGKey(1), **SMALL_LM))
    tokens, targets = common.synthetic_token_batch(3, 2, SMALL_LM["seq_len"],
                                                   vocab)
    tokens, targets = tokens.copy(), targets.copy()
    if where == "token":
        tokens[0, 5], tokens[1, 9] = vocab + 3, 10 * vocab
    elif where == "target":
        targets[1, 2] = vocab
    else:
        tokens[0, 1], targets[0, 3] = -1, -vocab - 2
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jb = (jnp.asarray(tokens), jnp.asarray(targets))
    jloss_fn = partial(jtrans.loss_fn, attn_fn=None)
    opt = jax_fused_adam(LR)
    jnew, _, jloss = jax_train_step(jloss_fn, opt)(jp, opt.init(jp), jb)
    _, jgrads = jax.value_and_grad(jloss_fn)(jp, jb)

    c = ProxyClient("127.0.0.1", proxy.port, "lm", 0.5, 1.0)
    try:
        p = common.to_device(convert.params_from_jax(params), "cpu")
        topt = fused_adam(LR)
        state = topt.init(p)
        step = common.make_train_step(ttrans.flash_loss_fn, topt)
        rp, rs = c.put_tree(p), c.put_tree(state)
        exe = c.compile(step, rp, rs, (tokens, targets))
        _, _, loss = exe(rp, rs, (tokens, targets))
        got_loss = float(c.get(loss))
        got = tree_leaves(convert.params_to_jax(c.get_tree(rp)))
    finally:
        c.close()
    if where == "token":
        assert got_loss == pytest.approx(float(jloss), rel=1e-3)
    else:
        assert np.isnan(got_loss) and np.isnan(float(jloss))
    for a, b, g in zip(jax.tree_util.tree_leaves(jnew), got,
                       jax.tree_util.tree_leaves(jgrads)):
        a, g = np.asarray(a), np.asarray(g, np.float32)
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, rtol=0, atol=2 * LR + 1e-6)
        firm = np.abs(g) > 1e-2
        np.testing.assert_allclose(b[firm], a[firm], rtol=0, atol=1e-6)


# --- factory ops -------------------------------------------------------------------

def _model_nodes(archive: bytes) -> list:
    zf = zipfile.ZipFile(io.BytesIO(archive))
    name = next(n for n in zf.namelist() if n.endswith("models/model.json"))
    return json.loads(zf.read(name))["graph_module"]["graph"]["nodes"]


def _factory(x):
    # aten factories called with no device: host tensors on the proxy
    # unless given its device
    return (x + torch.ops.aten.zeros.default([4]),
            torch.ops.aten.full.default([256], 3.0),
            x * torch.ops.aten.scalar_tensor.default(2.0))


def test_a_factory_op_without_a_device_is_given_the_proxys():
    blob, *_ = exported.export_program(_factory, (torch.zeros(4),), "cpu")
    nodes = _model_nodes(blob)
    bare = [n["target"] for n in nodes
            if "zeros" in n["target"] or "full" in n["target"]
            or "scalar_tensor" in n["target"]]
    assert len(bare) == 3
    assert all(not any(i["name"] == "device" for i in n["inputs"])
               for n in nodes if n["target"] in bare)
    _, archive = exported.canonical_archive(blob, "cuda:0")
    for n in _model_nodes(archive):
        if n["target"] in bare:
            dev = [i["arg"] for i in n["inputs"] if i["name"] == "device"]
            assert dev == [{"as_device": {"type": "cuda", "index": 0}}]
    prog = exported.load_program(blob, "cpu")
    devices = [n.kwargs.get("device") for n in prog._module.graph.nodes
               if n.op == "call_function"
               and any(a.name == "device"
                       for a in getattr(n.target, "_schema",
                                        torch.ops.aten.add.Tensor._schema)
                       .arguments)]
    assert devices == [torch.device("cpu")] * 3


def test_a_factory_ops_tensor_is_charged_to_the_session(proxy):
    c = ProxyClient("127.0.0.1", proxy.port, "fac", 0.5, 1.0)
    try:
        bx = c.put(np.ones(4, dtype=np.float32))
        exe = c.compile(_factory, bx)
        a, filled, b = exe(bx)
        np.testing.assert_array_equal(c.get(filled), np.full(256, 3.0))
        acct = proxy.hbm_accounting()["fac"]
        assert acct["balanced"]
        assert acct["hbm_used"] == 16 + 16 + 256 * 4 + 16
        c.free(filled)
        assert proxy.hbm_accounting()["fac"]["hbm_used"] == 48
    finally:
        c.close()
