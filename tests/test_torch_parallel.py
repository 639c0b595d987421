"""The port's meshes, shardings, sharded train step, pipeline and carve
parsers against the JAX package's ``parallel/`` and ``gang/carve.py``.

The JAX side runs on the conftest's 8 virtual CPU devices; the port's on 2
or 4 gloo ranks in processes of their own (``utils.virtualcpu.RankPool``,
one pool of each size for the module; the rank halves are in
``torch_ranks.py``). Inputs and params are made with numpy (or the JAX
init) from a seed and carried across by ``convert``. Models run in fp32
on both sides, so the sharded steps differ only in the order of their
sums: the loss is held to 1e-5 relative, grads to 1e-5 absolute plus
2e-4 relative (batchnorm's statistics under dp are sums over the ranks,
in another order than XLA's: a few of cifar10's grads move by 1e-4 of
themselves), and the params after one Adam step as the single-device
parity tests hold them (every param to 2·lr, those with |g| > 1e-4 to
1e-6).
"""

from functools import lru_cache

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_ranks as ranks
from kubeshare_tpu.gang import carve as jcarve
from kubeshare_tpu.models import cifar10 as jcifar
from kubeshare_tpu.models import mnist as jmnist
from kubeshare_tpu.models import transformer as jtrans
from kubeshare_tpu.ops import moe as jmoe
from kubeshare_tpu.parallel import mesh as jmesh
from kubeshare_tpu.parallel import pipeline as jpipe
from kubeshare_tpu_torch import convert
from kubeshare_tpu_torch.gang import carve as tcarve
from kubeshare_tpu_torch.models import common
from kubeshare_tpu_torch.ops import moe as tmoe
from kubeshare_tpu_torch.parallel import mesh as tmesh
from kubeshare_tpu_torch.parallel import pipeline as tpipe
from kubeshare_tpu_torch.utils.virtualcpu import RankPool

LR = 1e-3
LM_SMALL = dict(seq_len=16, vocab=64, dim=32, layers=1)


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4) as pool:
        yield pool


def _spec(placements, names, ndim):
    """DTensor placements over ``names`` → the JAX PartitionSpec."""
    axes = [[] for _ in range(ndim)]
    for name, pl in zip(names, placements):
        if isinstance(pl, Shard):
            axes[pl.dim].append(name)
        else:
            assert isinstance(pl, Replicate)
    spec = [None if not a else a[0] if len(a) == 1 else tuple(a)
            for a in axes]
    while spec and spec[-1] is None:
        spec.pop()
    return P(*spec)


def _norm(spec: P) -> P:
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return P(*spec)


# --- meshes ---------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_and_default_tp_match_jax(n):
    assert tmesh._default_tp(n) == jmesh._default_tp(n)
    tm = tmesh.make_mesh(range(n), device_type="cpu")
    jm = jmesh.make_mesh(jax.devices()[:n])
    assert tuple(tm.mesh_dim_names) == jm.axis_names == ("dp", "tp")
    assert tuple(tm.mesh.shape) == jm.devices.shape
    np.testing.assert_array_equal(
        tm.mesh.numpy(), np.vectorize(lambda d: d.id)(jm.devices))
    for dp in (1, 2, 4):
        if n % dp == 0:
            assert tuple(tmesh.make_mesh(range(n), dp=dp,
                                         device_type="cpu").mesh.shape) == \
                jmesh.make_mesh(jax.devices()[:n], dp=dp).devices.shape
    for bad in (dict(dp=0), dict(dp=3, tp=3)):
        with pytest.raises(ValueError) as te:
            tmesh.make_mesh(range(n), device_type="cpu", **bad)
        with pytest.raises(ValueError) as je:
            jmesh.make_mesh(jax.devices()[:n], **bad)
        assert str(te.value) == str(je.value)


def test_param_and_batch_shardings_match_jax_specs():
    """Each leaf's placements are the JAX PartitionSpec, for the LM over
    (dp=2, tp=4) and for the data and token layouts over meshes with dcn
    and sp axes."""
    params = jax.tree_util.tree_map(np.asarray, jtrans.init(
        jax.random.key(0, impl="rbg"), **LM_SMALL))
    tm = tmesh.make_mesh(range(8), dp=2, tp=4, device_type="cpu")
    jm = jmesh.make_mesh(jax.devices(), dp=2, tp=4)
    got = tmesh._placement_leaves(tmesh.param_sharding(tm, params))
    want = jax.tree_util.tree_leaves(jmesh.param_sharding(jm, params))
    leaves = jax.tree_util.tree_leaves(params)
    assert len(got) == len(want) == len(leaves)
    n_split = 0
    for pl, ns, x in zip(got, want, leaves):
        assert _spec(pl, ("dp", "tp"), x.ndim) == _norm(ns.spec)
        n_split += any(isinstance(p, Shard) for p in pl)
    assert n_split >= 5
    for names, sizes in ((("dp", "tp"), (4, 2)),
                         (("dcn", "dp", "tp"), (2, 2, 2)),
                         (("dp", "sp", "tp"), (2, 2, 2))):
        tm = tmesh.new_mesh(np.arange(8).reshape(sizes), names, "cpu")
        jm = Mesh(np.array(jax.devices()).reshape(sizes), names)
        for tf, jf in ((tmesh.data_sharding, jmesh.data_sharding),
                       (tmesh.token_sharding, jmesh.token_sharding),
                       (tmesh.replicated, jmesh.replicated)):
            assert _spec(tf(tm), names, 2) == _norm(jf(jm).spec)


def test_hybrid_and_carved_meshes_match_jax():
    """``make_hybrid_mesh`` lays the ranks as JAX lays the devices; a
    wrap-around carve orders them by block position; a scattered carve
    raises ``CarveError`` in both."""
    devs = jax.devices()
    slices = [list(range(0, 4)), list(range(4, 8))]
    for tp in (None, 2, 4):
        tm = tmesh.make_hybrid_mesh(slices, tp=tp, device_type="cpu")
        jm = jmesh.make_hybrid_mesh([devs[:4], devs[4:]], tp=tp)
        assert tuple(tm.mesh_dim_names) == jm.axis_names
        np.testing.assert_array_equal(
            tm.mesh.numpy(), np.vectorize(lambda d: d.id)(jm.devices))
    for bad in (dict(device_slices=[[0, 1], [2]]), dict(tp=3)):
        kw = dict(dict(device_slices=slices), **bad)
        with pytest.raises(ValueError) as te:
            tmesh.make_hybrid_mesh(kw["device_slices"], tp=kw.get("tp"),
                                   device_type="cpu")
        jslices = [[devs[i] for i in s] for s in kw["device_slices"]]
        with pytest.raises(ValueError) as je:
            jmesh.make_hybrid_mesh(jslices, tp=kw.get("tp"))
        assert str(te.value) == str(je.value)
    # a 1x4 block on a 2x4 torus that wraps its second axis: 2, 3, 0, 1
    wrap = "c0@0.2,c1@0.3,c2@0.0,c3@0.1"
    tm = tmesh.make_carved_mesh(wrap, range(4), mesh_shape="2x4",
                                device_type="cpu")
    jm = jmesh.make_carved_mesh(wrap, devs[:4], mesh_shape="2x4")
    np.testing.assert_array_equal(
        tm.mesh.numpy(), np.vectorize(lambda d: d.id)(jm.devices))
    square = "a@1.1,b@0.0,c@0.1,d@1.0"
    tm = tmesh.make_carved_mesh(square, range(4), device_type="cpu")
    jm = jmesh.make_carved_mesh(square, devs[:4])
    np.testing.assert_array_equal(
        tm.mesh.numpy(), np.vectorize(lambda d: d.id)(jm.devices))
    for carve in ("c0@0.0,c1@0.2", "c0@0.0,c1@1.1"):
        with pytest.raises(tcarve.CarveError) as te:
            tmesh.make_carved_mesh(carve, range(2), mesh_shape="2x4",
                                   device_type="cpu")
        with pytest.raises(jcarve.CarveError) as je:
            jmesh.make_carved_mesh(carve, devs[:2], mesh_shape="2x4")
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("text", [
    "c0@0.0,c1@0.1", "a,b@1.2, c ,", "x@3", "@1", "a@1.x", "",
    "c0@0.3,c1@0.0", "c0@0.0,c1@1.1", "c0@0.0,c0@0.0", "c0@0,c1@0.1"])
def test_carve_parsers_match_jax(text):
    def both(fn, *args, **kw):
        out = []
        for mod in (tcarve, jcarve):
            try:
                out.append(("ok", getattr(mod, fn)(*args, **kw)))
            except mod.CarveError as e:
                out.append(("CarveError", str(e)))
        assert out[0] == out[1], (fn, args, out)
        return out[0]

    both("strip_carve", text)
    kind, entries = both("parse_visible_chips", text)
    if kind == "ok":
        for mesh in (None, (2, 4), (4,), (1, 4)):
            kind, block = both("carve_block", entries, mesh=mesh)
            if kind == "ok":
                both("block_coords", *block, mesh=mesh)
    for shape in ("2x4", "4", "2x0", "ax2", " 1x1x8 "):
        both("parse_mesh", shape)


# --- the sharded train step ---------------------------------------------------

def _case(name: str):
    """JAX params (numpy) and a numpy batch of model ``name``, small."""
    key = jax.random.key(3, impl="rbg")
    if name == "transformer":
        params = jtrans.init(key, **LM_SMALL)
        batch = common.synthetic_token_batch(4, 4, LM_SMALL["seq_len"],
                                             LM_SMALL["vocab"])
    elif name == "mnist":
        params = jmnist.init(key)
        batch = common.synthetic_image_batch(4, 4, 28, 1, 10)
    else:
        params = jcifar.init(key)
        batch = common.synthetic_image_batch(4, 4, 32, 3, 10)
    return jax.tree_util.tree_map(np.asarray, params), batch


@lru_cache(maxsize=None)
def _jax_sharded(name: str):
    """JAX's sharded step over (dp=2, tp=2): loss, grads, params after one
    Adam step, fp32 activations."""
    mod = {"mnist": jmnist, "cifar10": jcifar, "transformer": jtrans}[name]
    saved = mod.DTYPE
    mod.DTYPE = jnp.float32
    try:
        params, batch = _case(name)
        mesh = jmesh.make_mesh(jax.devices()[:4], dp=2, tp=2)
        opt = optax.adam(LR)
        step = jmesh.make_sharded_train_step(mod.loss_fn, opt, mesh)
        jp = jax.device_put(params, jmesh.param_sharding(mesh, params))
        jb = jax.device_put(tuple(jnp.asarray(a) for a in batch),
                            jmesh.data_sharding(mesh))
        loss, grads = jax.jit(jax.value_and_grad(mod.loss_fn))(jp, jb)
        new, _, loss2 = step(jp, opt.init(jp), jb)
        assert float(loss2) == pytest.approx(float(loss), rel=1e-6)
        return (float(loss),
                [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)],
                [np.asarray(p) for p in jax.tree_util.tree_leaves(new)],
                jax.tree_util.tree_leaves(jmesh.param_sharding(mesh,
                                                               params)))
    finally:
        mod.DTYPE = saved


MESHES = {"dp2": {"dp": 2, "tp": 1}, "tp2": {"dp": 1, "tp": 2},
          "dp2tp2": {"dp": 2, "tp": 2}}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", ["mnist", "transformer", "cifar10"])
def test_sharded_step_matches_jax(pool2, pool4, name, mesh):
    """One step of the port's sharded step at dp = 2, tp = 2 and
    dp = 2 × tp = 2 against JAX's sharded step: the global loss, every
    gradient and every param after the step. cifar10's batchnorm takes
    the global batch's statistics under dp, as XLA's does."""
    params, batch = _case(name)
    pool = pool4 if mesh == "dp2tp2" else pool2
    tloss, tgrads, tparams, tplace = pool.run(
        ranks.sharded_step, name, MESHES[mesh],
        convert.params_from_jax(params), batch, LR)[0]
    jloss, jgrads, jparams, jshard = _jax_sharded(name)
    assert tloss == pytest.approx(jloss, rel=1e-5)
    assert len(tgrads) == len(jgrads)
    for a, b in zip(jgrads, tgrads):
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=1e-5)
    n_firm = 0
    for a, b, g in zip(jparams, tparams, jgrads):
        np.testing.assert_allclose(b, a, rtol=0, atol=2 * LR + 1e-6)
        firm = np.abs(g) > 1e-4
        n_firm += int(firm.sum())
        np.testing.assert_allclose(b[firm], a[firm], rtol=0, atol=1e-6)
    assert n_firm > 100
    names = tuple(MESHES[mesh])
    for pl, ns, x in zip(tplace, jshard, jparams):
        if MESHES[mesh]["tp"] == 2:
            assert _spec(pl, names, x.ndim) == _norm(ns.spec)


def test_moe_under_a_split_batch_raises_naming_its_entry(pool2):
    """The MoE LM routes over the global batch in JAX; under dp = 2 the
    port raises rather than route per rank."""
    from kubeshare_tpu_torch.models import transformer as ttrans

    params = ttrans.init(0, n_experts=2, **LM_SMALL)
    batch = common.synthetic_token_batch(1, 4, LM_SMALL["seq_len"],
                                         LM_SMALL["vocab"])
    errors = pool2.run(ranks.sharded_step, "transformer", MESHES["dp2"],
                       params, batch, LR, catch=True)
    for e in errors:
        assert e.startswith("NotImplementedError")
        assert "ROADMAP queue 3" in e and "mixture of experts" in e


def test_expert_sharding_matches_jax():
    params = jax.tree_util.tree_map(np.asarray, jmoe.moe_init(
        jax.random.key(0, impl="rbg"), 8, 16, 4))
    for names, sizes in ((("dp", "ep"), (2, 4)), (("ep",), (8,))):
        tm = tmesh.new_mesh(np.arange(8).reshape(sizes), names, "cpu")
        jm = Mesh(np.array(jax.devices()).reshape(sizes), names)
        got = tmoe.expert_sharding(tm, params)
        want = jmoe.expert_sharding(jm, params)
        assert set(got) == set(want)
        for k in got:
            assert _spec(got[k], names, params[k].ndim) == \
                _norm(want[k].spec)
    tm = tmesh.make_mesh(range(4), device_type="cpu")
    jm = jmesh.make_mesh(jax.devices()[:4])
    with pytest.raises(ValueError) as te:
        tmoe.expert_sharding(tm, params)
    with pytest.raises(ValueError) as je:
        jmoe.expert_sharding(jm, params)
    assert str(te.value) == str(je.value)


# --- the pipeline ------------------------------------------------------------------

@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_matches_jax(pool2, pool4, stages):
    """S stages of tanh(x·w + b) over 3 microbatches: the replicated
    outputs and every stage's grads of sum(ys²), against JAX's
    ``make_pipeline`` over a (pp,) mesh; fp32, held to 1e-5."""
    rng = np.random.default_rng(stages)
    d = 6
    stacked = {"w": (rng.standard_normal((stages, d, d)) * 0.5
                     ).astype(np.float32),
               "b": rng.standard_normal((stages, d)).astype(np.float32)}
    xs = np.asarray(jpipe.microbatch(
        rng.standard_normal((6, d)).astype(np.float32), 3))
    assert xs.shape == tuple(tpipe.microbatch(torch.tensor(
        rng.standard_normal((6, d))), 3).shape)
    mesh = Mesh(np.array(jax.devices()[:stages]), ("pp",))

    def stage(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    fn = jpipe.make_pipeline(mesh, stage)
    params = jax.device_put(stacked, jpipe.stage_sharding(mesh, stacked))
    def ys_and_grads(p):
        return fn(p, xs), jax.grad(lambda q: (fn(q, xs) ** 2).sum())(p)

    ys, grads = jax.jit(ys_and_grads)(params)
    pool = pool2 if stages == 2 else pool4
    tys, tgrads = pool.run(ranks.pipeline_run, stages, stacked, xs)[0]
    np.testing.assert_allclose(tys, np.asarray(ys), rtol=0, atol=1e-5)
    for k in stacked:
        np.testing.assert_allclose(tgrads[k], np.asarray(grads[k]),
                                   rtol=0, atol=1e-5)
    tm = tmesh.new_mesh(np.arange(stages), ("pp",), "cpu")
    places = tmesh._placement_leaves(tpipe.stage_sharding(tm, stacked))
    specs = jax.tree_util.tree_leaves(jpipe.stage_sharding(mesh, stacked))
    for pl, ns, k in zip(places, specs, sorted(stacked)):
        assert _spec(pl, ("pp",), stacked[k].ndim) == _norm(ns.spec)
    with pytest.raises(ValueError, match="no 'pp' axis"):
        tpipe.make_pipeline(tmesh.make_mesh(range(2), device_type="cpu"),
                            stage)
