"""Rank-side halves of the port's multi-rank tests (``test_torch_parallel``,
``test_torch_ring``, ``test_torch_runner``, ``test_torch_elastic``):
module-level functions that
:class:`kubeshare_tpu_torch.utils.virtualcpu.RankPool` runs on every gloo
rank. They import no JAX, so a rank process pays torch's import only; the
test modules compute the JAX side and compare.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from kubeshare_tpu_torch.models import common
from kubeshare_tpu_torch.ops.fused_adam import Optimizer, fused_adam
from kubeshare_tpu_torch.parallel import collectives as coll
from kubeshare_tpu_torch.parallel import mesh as pmesh
from kubeshare_tpu_torch.utils.tree import tree_flatten, tree_map


def _mesh(shape: dict):
    names = tuple(shape)
    ranks = np.arange(dist.get_world_size()).reshape(tuple(shape.values()))
    return pmesh.new_mesh(ranks, names, "cpu")


def _like(local, like):
    """``local`` as a DTensor laid out as ``like``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def _full(x, mesh) -> np.ndarray:
    """The whole of a (possibly DTensor) leaf as numpy, on every rank."""
    local = pmesh.to_local(x).detach()
    for dim, group in pmesh.gather_plan(x, mesh):
        local = coll._gather(local, dim, group)
    return local.float().numpy().copy()


def _model(name: str, dtype):
    from kubeshare_tpu_torch.models import cifar10, mnist, transformer

    mod = {"mnist": mnist, "cifar10": cifar10,
           "transformer": transformer}[name]
    mod.DTYPE = dtype
    return mod


def sharded_step(name: str, mesh_shape: dict, params, batch, lr: float,
                 dtype=torch.float32, token: bool = False,
                 catch: bool = False):
    """One fused-Adam step of model ``name`` over a mesh of
    ``mesh_shape``: (loss, grads, params after) as whole numpy arrays, on
    rank 0 (None elsewhere). With ``catch``, the error it raises on
    every rank, as ``"Type: message"``."""
    if catch:
        try:
            sharded_step(name, mesh_shape, params, batch, lr, dtype, token)
        except Exception as e:
            return f"{type(e).__name__}: {e}"
        return ""
    mod = _model(name, dtype)
    mesh = _mesh(mesh_shape)
    seen = {}
    adam = fused_adam(lr)

    def update(grads, state, ps):
        seen["grads"] = tree_map(lambda g: g.detach().clone(), grads)
        return adam.update(grads, state, ps)

    opt = Optimizer(adam.init, update)
    bs = (pmesh.token_sharding if token else pmesh.data_sharding)(mesh)
    gp = common.to_device(params, "cpu")
    state = opt.init(gp)
    p = pmesh.shard_tree(gp, pmesh.param_sharding(mesh, gp), mesh)
    s = pmesh.shard_tree(state, pmesh.param_sharding(mesh, state), mesh)
    b = pmesh.shard_tree(common.to_device(batch, "cpu"), bs, mesh)
    step = pmesh.make_sharded_train_step(mod.loss_fn, opt, mesh, bs)
    p, s, loss = step(p, s, b)
    # the gradients are local shards: rebuild them as the params are
    leaves = tree_flatten(p)[0]
    grads = [_full(_like(g, x), mesh)
             for g, x in zip(tree_flatten(seen["grads"])[0], leaves)]
    out = (float(loss), grads, [_full(x, mesh) for x in leaves],
           [tuple(x.placements) for x in leaves])
    return out if dist.get_rank() == 0 else None


def seq_attention(kind: str, sp: int, q, k, v, causal: bool, gout):
    """Ring / ring-flash / Ulysses / Ulysses-flash over ``sp`` (the
    world), each rank on its sequence block: the gathered output and the
    gathered grads of sum(out * gout) in q, k, v, on rank 0."""
    from kubeshare_tpu_torch.ops.flash_attention import flash_attention
    from kubeshare_tpu_torch.parallel import ringattention, ulysses

    mesh = _mesh({"sp": sp})
    me = dist.get_rank()
    blk = q.shape[1] // sp
    cut = lambda a: torch.tensor(a[:, me * blk:(me + 1) * blk]
                                 ).requires_grad_(True)
    ql, kl, vl = cut(q), cut(k), cut(v)
    if kind == "ring":
        attn = ringattention.make_ring_attention(mesh, causal=causal)
    elif kind == "ring_flash":
        attn = ringattention.make_ring_flash_attention(
            mesh, causal=causal, block_q=4, block_k=4)
    elif kind == "ulysses":
        attn = ulysses.make_ulysses_attention(mesh, causal=causal)
    else:
        attn = ulysses.make_ulysses_attention(
            mesh, causal=False, attn_fn=partial(
                flash_attention, causal=causal, block_q=4, block_k=4))
    out = attn(ql, kl, vl)
    (out * torch.tensor(gout[:, me * blk:(me + 1) * blk])).sum().backward()
    group = coll.axis_group(mesh, "sp")
    res = [coll._gather(t.detach(), 1, group).numpy()
           for t in (out, ql.grad, kl.grad, vl.grad)]
    return res if me == 0 else None


def ulysses_refusals(h: int, hk: int):
    """The Ulysses checks' messages, raised before any exchange."""
    from kubeshare_tpu_torch.parallel import ulysses

    mesh = _mesh({"sp": dist.get_world_size()})
    out = []
    for kw in ({}, {"attn_fn": lambda q, k, v: q}):
        q = torch.zeros(1, 4, h, 8)
        k = torch.zeros(1, 4, hk, 8)
        try:
            ulysses.ulysses_attention_shard(q, k, k, "sp", mesh=mesh, **kw)
            out.append("")
        except ValueError as e:
            out.append(str(e))
    return out


def lm_loss_for_mesh(mesh_shape: dict, kind: str, params, batch, env: dict):
    """The LM's loss and whole grads through ``run``'s mesh hooks
    (``_loss_for_mesh`` under ``KUBESHARE_TPU_SP_ATTN=kind``), or the
    error it raises."""
    import os

    from kubeshare_tpu_torch.models import transformer

    mesh = _mesh(mesh_shape)
    old = {k: os.environ.get(k) for k in (*env, "KUBESHARE_TPU_SP_ATTN")}
    os.environ.update(env, KUBESHARE_TPU_SP_ATTN=kind)
    saved = (transformer.WINDOW, transformer.DTYPE)
    try:
        transformer.WINDOW = int(env.get(
            "KUBESHARE_TPU_TRANSFORMER_WINDOW", 0)) or None
        transformer.DTYPE = torch.float32
        try:
            loss_fn = transformer._loss_for_mesh(mesh)
        except ValueError as e:
            return ("error", str(e))
        bs = transformer._token_sharding_hook(mesh)
        gp = common.to_device(params, "cpu")
        p = pmesh.shard_tree(gp, pmesh.param_sharding(mesh, gp), mesh)
        b = pmesh.shard_tree(common.to_device(batch, "cpu"), bs, mesh)
        seen = {}

        def update(grads, state, ps):
            seen["grads"] = grads
            return ps, state

        step = pmesh.make_sharded_train_step(
            loss_fn, Optimizer(lambda ps: {}, update), mesh, bs)
        _, _, loss = step(p, {}, b)
        leaves = tree_flatten(p)[0]
        grads = [_full(_like(g, x), mesh)
                 for g, x in zip(tree_flatten(seen["grads"])[0], leaves)]
        return ("ok", float(loss), grads) if dist.get_rank() == 0 else None
    finally:
        transformer.WINDOW, transformer.DTYPE = saved
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def pipeline_run(size: int, stacked, xs):
    """The pipeline over ``size`` stages (the world): ys and the grads of
    sum(ys²) in every rank's stage, gathered on rank 0."""
    from kubeshare_tpu_torch.parallel import pipeline

    mesh = _mesh({"pp": size})
    me = dist.get_rank()
    local = {k: torch.tensor(v[me:me + 1]).requires_grad_(True)
             for k, v in stacked.items()}

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    ys = pipeline.make_pipeline(mesh, stage)(local, torch.tensor(xs))
    (ys ** 2).sum().backward()
    group = coll.axis_group(mesh, "pp")
    grads = {k: coll._gather(t.grad, 0, group).numpy()
             for k, t in local.items()}
    return (ys.detach().numpy(), grads) if me == 0 else None


def mesh_layouts():
    """The axes and this rank's coordinates of the meshes the runner and
    the hybrid builder give over the world."""
    from kubeshare_tpu_torch.parallel import runner

    n = dist.get_world_size()
    out = {}
    for label, m in (("gang", runner.gang_mesh(device_type="cpu")),
                     ("hybrid", runner.gang_mesh(hybrid=True,
                                                 device_type="cpu")),
                     ("made", pmesh.make_hybrid_mesh(
                         [[0, 1], [2, 3]] if n == 4 else [[0], [1]],
                         device_type="cpu"))):
        out[label] = (tuple(m.mesh_dim_names), tuple(m.mesh.shape),
                      tuple(m.get_coordinate()))
    return out


def gang_checkpoint(path: str, mesh_shape: dict, params, save: bool):
    """Save (``save``) or restore a checkpoint of params laid out over a
    mesh: the step and whole params restored, on rank 0."""
    from kubeshare_tpu_torch.models import checkpoint as ck

    mesh = _mesh(mesh_shape)
    gp = common.to_device(params, "cpu")
    p = pmesh.shard_tree(gp, pmesh.param_sharding(mesh, gp), mesh)
    state = {"count": torch.zeros(())}
    if save:
        ck.save_checkpoint(path, p, state, 7)
        return None
    like = tree_map(lambda x: torch.zeros_like(x), p)
    rp, rs, step = ck.load_checkpoint(path, like, state)
    got = (step, [_full(x, mesh) for x in tree_flatten(rp)[0]],
           [tuple(x.placements) for x in tree_flatten(rp)[0]])
    return got if dist.get_rank() == 0 else None


def shared_path(paths, wait_s: float):
    """``verify_shared_path`` with a path per rank: None when it passes,
    the ``SystemExit`` message when it does not."""
    from kubeshare_tpu_torch.models import checkpoint as ck

    ck.SHARED_PROBE_WAIT_S = wait_s
    try:
        ck.verify_shared_path(paths[dist.get_rank()])
        return None
    except SystemExit as e:
        return str(e)


# --- the elastic plane -----------------------------------------------------------

def _adam_tree(params, lr: float):
    """Host tensors of ``params`` and fused Adam's state over them."""
    gp = common.to_device(params, "cpu")
    return gp, fused_adam(lr).init(gp)


def _whole(tree) -> list:
    """Every leaf of a tree laid out on a mesh, whole, on the mesh's
    ranks (None on a rank outside it)."""
    out = []
    for x in tree_flatten(tree)[0]:
        if x.device_mesh.get_coordinate() is None:
            out.append(None)
        else:
            out.append(_full(x, x.device_mesh))
    return out


def elastic_restate(transition: str, params, lr: float):
    """``restate_state`` of params and Adam's state through the meshes of
    ``transition`` ("grow-shrink": ranks [0, 1] → [0..3] → [0];
    "relayout": (dp=4, tp=1) → (dp=2, tp=2) over [0..3]): each step's
    stats, and the whole leaves after each, on rank 0."""
    from kubeshare_tpu_torch.elastic.restate import place_tree, restate_state

    if transition == "grow-shrink":
        meshes = [pmesh.make_mesh(r, device_type="cpu")
                  for r in ([0, 1], [0, 1, 2, 3], [0])]
    else:
        meshes = [pmesh.make_mesh([0, 1, 2, 3], dp=dp, tp=tp,
                                  device_type="cpu")
                  for dp, tp in ((4, 1), (2, 2))]
    gp, state = _adam_tree(params, lr)
    p, s = place_tree(gp, meshes[0]), place_tree(state, meshes[0])
    steps = []
    for mesh in meshes[1:]:
        p, s, stats = restate_state(p, s, mesh)
        steps.append((stats, _whole(p) + _whole(s),
                      [tuple(x.placements) for x in tree_flatten(p)[0]]))
    return steps if dist.get_rank() == 0 else None


def elastic_trainer(params, batches, lr: float, resize_at: dict):
    """An ``ElasticTrainer`` of tinymlp over ranks [0, 1], resized before
    the steps in ``resize_at`` (step -> ranks), and an unresized one on
    the same batches: losses, resize records and whole final params of
    each, on rank 0; every rank's step count and losses."""
    from kubeshare_tpu_torch.elastic import ElasticTrainer
    from kubeshare_tpu_torch.models import tinymlp

    runs = {}
    for label, at in (("elastic", resize_at), ("base", {})):
        tr = ElasticTrainer(tinymlp.loss_fn, fused_adam(lr), params,
                            devices=[0, 1], device_type="cpu")
        for i, b in enumerate(batches):
            if i in at:
                tr.resize(at[i])
            tr.train_step(b)
        runs[label] = {
            "step": tr.step, "losses": tr.losses,
            "resizes": [(r["step"], r["chips"], r["stats"])
                        for r in tr.resizes],
            "params": _whole(tr.params), "count": _whole(tr.opt_state)[0],
            "in_mesh": tr.in_mesh}
    return runs


def elastic_checkpoint(path: str, params, batches, lr: float):
    """Train tinymlp two steps on all four ranks, then
    ``restate_via_checkpoint`` onto rank 0 alone: the saved and the
    restored whole leaves and step, on rank 0."""
    from kubeshare_tpu_torch.elastic import (ElasticTrainer,
                                             restate_via_checkpoint)
    from kubeshare_tpu_torch.models import tinymlp

    tr = ElasticTrainer(tinymlp.loss_fn, fused_adam(lr), params,
                        devices=[0, 1, 2, 3], device_type="cpu")
    for b in batches:
        tr.train_step(b)
    saved = _whole(tr.params) + _whole(tr.opt_state)
    one = pmesh.make_mesh([0], device_type="cpu")
    p, s, step = restate_via_checkpoint(path, tr.params, tr.opt_state, one,
                                        step=tr.step)
    got = (saved, _whole(p) + _whole(s), step, tr.step,
           [tuple(x.device_mesh.mesh.flatten().tolist())
            for x in tree_flatten((p, s))[0]])
    return got if dist.get_rank() == 0 else None


def elastic_orchestrated(journal: str, params, batches, lr: float,
                         plan: dict, steal_at: int | None):
    """The smoke's elastic drive at tinymlp size: rank 0 hosts a
    dispatcher over a fake fleet with a four-member gang booked as
    ``elastic/sim.py`` books one and an ``ElasticOrchestrator`` whose
    restater announces each plan; before the steps in ``plan`` (step ->
    target chips) rank 0 resizes, the others follow. With ``steal_at``,
    that resize's destination chips are taken after its restate, so its
    flip fails and the trainer follows the mirrored plan back. Rank 0
    returns the outcomes, the trainer's resize records, losses and step,
    the journal's recovery and the mesh size at the end; the others their
    step and resize count."""
    from kubeshare_tpu_torch.elastic import (ElasticConfig,
                                             ElasticOrchestrator,
                                             ElasticTrainer, recover)
    from kubeshare_tpu_torch.elastic.sim import _gang_labels
    from kubeshare_tpu_torch.elastic.trainer import (announce, announcing,
                                                     follow)
    from kubeshare_tpu_torch.models import tinymlp

    def bank(k):
        return list(range(k))

    tr = ElasticTrainer(tinymlp.loss_fn, fused_adam(lr), params,
                        devices=bank(2), device_type="cpu")
    me = dist.get_rank()
    outcomes = []
    if me == 0:
        from kubeshare_tpu_torch.scheduler.dispatcher import Dispatcher
        from kubeshare_tpu_torch.scheduler.engine import SchedulerEngine
        from kubeshare_tpu_torch.topology.cell import reserve_resource
        from kubeshare_tpu_torch.topology.discovery import FakeTopology

        clk = [0.0]
        eng = SchedulerEngine(clock=lambda: clk[0])
        by_host: dict = {}
        for chip in FakeTopology(hosts=2, mesh=(2, 2)).chips():
            by_host.setdefault(chip.host, []).append(chip)
        for host, chips in sorted(by_host.items()):
            eng.add_node(host, chips)
        disp = Dispatcher(eng, clock=lambda: clk[0])
        for i in range(4):
            disp.submit("sim", f"trainer-{i}",
                        _gang_labels(0.25, "trainer", 4))
        disp.step(0.0)
        orch = ElasticOrchestrator(
            disp, cfg=ElasticConfig(pause_timeout_s=5.0, cooldown_s=0.0),
            journal_path=journal, clock=lambda: clk[0])
        # the members pack onto one chip: start the job on two, where the
        # trainer is (no restater yet)
        outcomes.append(orch.resize("sim/trainer", 2, now=0.0))
        inner = announcing(tr.restater(bank))
        steal = {"on": False}

        def restate(p):
            inner(p)
            if steal["on"] and not p.get("revert"):
                with disp.lock:
                    for mv in p["moves"]:
                        c = eng.leaf_cells[mv["to_chip"]]
                        reserve_resource(c, c.available, 0)

        orch.register_restater("sim/trainer", restate)
    for i, b in enumerate(batches):
        if me == 0:
            if i in plan:
                steal["on"] = i == steal_at
                outcomes.append(orch.resize("sim/trainer", plan[i],
                                            now=float(i)))
            announce(None)
        else:
            follow(tr, bank)
        tr.train_step(b)
    if me != 0:
        return {"step": tr.step, "resizes": len(tr.resizes)}
    return {"outcomes": outcomes, "step": tr.step, "losses": tr.losses,
            "resizes": [(r["step"], r["chips"]) for r in tr.resizes],
            "recover": recover(journal), "chips": tr.num_devices}
