"""Tests of the port that need an NVIDIA card (marker ``cuda``).

CUDA kernels have no CPU mode, so these skip on a machine without a card.
This file imports no JAX: it runs where the port runs. On the card::

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from kubeshare_tpu_torch.models import (cifar10, common, lstm, mnist, resnet,
                                        transformer, vgg)
from kubeshare_tpu_torch.ops import flash_attention as tfl
from kubeshare_tpu_torch.ops import fused_adam as tfa
from kubeshare_tpu_torch.utils.tree import tree_leaves

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    # full fp32 where numbers are compared (cuDNN convs default to TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(1024,), (8, 128), (37,), (3, 5, 7),
                                   (3136, 256)])
def test_kernel_matches_plain_on_card(cuda, shape):
    rng = np.random.default_rng(3)
    host = [rng.normal(size=shape).astype(np.float32) for _ in range(4)]
    host[3] = np.abs(host[3])
    dev = [torch.from_numpy(a).to(cuda) for a in host]
    step = torch.tensor(3.0, device=cuda)
    kern = [t.clone() for t in dev]
    plain = [t.clone() for t in dev]
    before = tfa.launches
    tfa.adam_update(*kern, step, lr=1e-2)
    tfa.adam_update_reference(*plain, step, lr=1e-2)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    for i in (0, 2, 3):
        torch.testing.assert_close(kern[i], plain[i], rtol=1e-6, atol=1e-6)


def _adam_trees(cuda, init_fn, seed, copies=2):
    """``copies`` identical (p, g, m, v) lists of the model's leaf shapes
    on the card (random, v >= 0), the first leaf of each a view that
    starts 4 bytes into its storage (not 16-byte aligned: the kernel's
    scalar path)."""
    rng = np.random.default_rng(seed)
    shapes = [np.shape(a) for a in tree_leaves(init_fn(0))]
    host = []
    for i in range(4):
        leaves = [rng.normal(size=int(np.prod(s)) + (j == 0)).astype(
            np.float32) for j, s in enumerate(shapes)]
        host.append([np.abs(a) for a in leaves] if i == 3 else leaves)
    return [[[torch.from_numpy(a).to(cuda)[(j == 0):].view(s)
              for j, (a, s) in enumerate(zip(leaves, shapes))]
             for leaves in host] for _ in range(copies)]


@pytest.mark.parametrize("model", [mnist, transformer],
                         ids=["mnist", "transformer"])
def test_multi_tensor_adam_matches_plain_on_card(cuda, model):
    """One launch updates the whole tree (an unaligned leaf included),
    bit for bit as the plain version leaf by leaf."""
    kern, plain = _adam_trees(cuda, model.init, 4)
    assert kern[0][0].data_ptr() % 16 != 0
    step = torch.tensor(3.0, device=cuda)
    before = tfa.launches
    tfa.adam_update_tree(*kern, step, lr=1e-2)
    for p, g, m, v in zip(*plain):
        tfa.adam_update_reference(p, g, m, v, step, lr=1e-2)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1 == before + tfa.tree_launches(kern[0])
    for i in (0, 2, 3):
        for got, want in zip(kern[i], plain[i]):
            assert torch.equal(got, want)


def test_multi_tensor_adam_splits_a_large_tree_on_card(cuda):
    """A tree of more leaves than one table takes the fewest launches."""
    n = 2 * tfa.TABLE_LEAVES + 3
    rng = np.random.default_rng(6)
    tree = [[torch.from_numpy(np.abs(rng.normal(size=5 + i)).astype(
        np.float32)).to(cuda) for i in range(n)] for _ in range(4)]
    plain = [[t.clone() for t in leaves] for leaves in tree]
    step = torch.tensor(2.0, device=cuda)
    before = tfa.launches
    tfa.adam_update_tree(*tree, step)
    for p, g, m, v in zip(*plain):
        tfa.adam_update_reference(p, g, m, v, step)
    torch.cuda.synchronize()
    assert tfa.launches - before == tfa.tree_launches(tree[0]) == 3
    for i in (0, 2, 3):
        for got, want in zip(tree[i], plain[i]):
            assert torch.equal(got, want)


@pytest.mark.parametrize("tree,launches", [("65 leaves", 2),
                                            ("resnet18", 2),
                                            ("resnet50", 3)])
def test_adam_past_one_table_matches_plain_on_card(cuda, tree, launches):
    """Past TABLE_LEAVES (64) leaves a step splits into more launches:
    65 leaves and ResNet-18's 76 take 2, the ResNet-50-class tree's 140
    take 3; every leaf bit for bit as the plain version."""
    init = {"65 leaves": lambda seed: [np.zeros(7 + i, np.float32)
                                       for i in range(65)],
            "resnet18": resnet.init, "resnet50": resnet.init50}[tree]
    kern, plain = _adam_trees(cuda, init, 5)
    step = torch.tensor(3.0, device=cuda)
    for _ in range(2):          # the second call takes the cached tables
        before = tfa.launches
        tfa.adam_update_tree(*kern, step, lr=1e-2)
        assert tfa.launches - before == tfa.tree_launches(kern[0]) \
            == launches
        for p, g, m, v in zip(*plain):
            tfa.adam_update_reference(p, g, m, v, step, lr=1e-2)
        torch.cuda.synchronize()
        for i in (0, 2, 3):
            for got, want in zip(kern[i], plain[i]):
                assert torch.equal(got, want)


#: the zoo's models at full width: (module, init keywords, loss name)
ZOO = {"cifar10": (cifar10, {}, "loss_fn"), "resnet18": (resnet, {}, "loss_fn"),
       "resnet50": (resnet, {"blocks_per_stage": resnet.RESNET50_BLOCKS},
                    "loss_fn"),
       "vgg16": (vgg, {}, "loss_fn"), "lstm": (lstm, {}, "loss_fn"),
       "moe_lm": (transformer, {"n_experts": 4}, "flash_loss_fn"),
       "lm_hd64": (transformer, {"dim": 512}, "flash_loss_fn"),
       "lm_hd128": (transformer, {"dim": 1024}, "flash_loss_fn"),
       "lm_hd80": (transformer, {"dim": 640}, "flash_loss_fn"),
       "lm_hd256": (transformer, {"dim": 2048, "layers": 2},
                    "flash_loss_fn")}


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_train_step_card_matches_cpu(cuda, monkeypatch, name):
    """One fp32 step of each zoo model at full width on 2 rows of its
    batch, the card (kernels, cuDNN, cuBLAS) against the CPU (plain
    versions): loss to 1e-5 relative, grads to 1e-4 of the model's own
    largest |g| (as chip_smoke.py's ZOO_GRAD_RTOL), every param to 2*lr
    and those with |g| > 1e-3 to 1e-5."""
    mod, kw, loss_name = ZOO[name]
    monkeypatch.setattr(mod, "DTYPE", torch.float32)
    loss_fn = getattr(mod, loss_name)
    lr = 1e-3
    params = mod.init(7, **kw)
    batch = tuple(a[:2] for a in mod.batch_fn(8))
    out = {}
    for where in ("cpu", cuda):
        p = common.to_device(params, where)
        b = common.to_device(batch, where)
        loss, grads = common.value_and_grad(loss_fn, p, b)
        opt = tfa.fused_adam(lr)
        p, _ = opt.update(grads, opt.init(p), p)
        out[str(where)] = (float(loss),
                           [t.cpu().numpy() for t in tree_leaves(p)],
                           [t.cpu().numpy() for t in tree_leaves(grads)])
    (lc, pc, gc), (lg, pg, gg) = out["cpu"], out[str(cuda)]
    assert lg == pytest.approx(lc, rel=1e-5)
    scale = max(float(np.abs(g).max()) for g in gc)
    for a, b in zip(gc, gg):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * scale)
    for a, b, g in zip(pc, pg, gc):
        np.testing.assert_allclose(b, a, atol=2 * lr + 1e-6, rtol=0)
        firm = np.abs(g) > 1e-3
        np.testing.assert_allclose(b[firm], a[firm], atol=1e-5, rtol=0)


def test_kernel_refuses_bad_args_on_card(cuda):
    x = torch.zeros(8, device=cuda)
    step = torch.tensor(1.0, device=cuda)
    with pytest.raises(TypeError):
        tfa.adam_update(x.double(), x.double(), x.double(), x.double(), step)
    with pytest.raises(ValueError):
        tfa.adam_update(x, x[:4], x, x, step)


def test_mnist_train_step_card_matches_cpu(cuda, monkeypatch):
    """One fp32 mnist step on the card (kernel) against the CPU (plain).
    Adam's first step is ~ -lr*sign(g): where |g| is near eps the two
    devices' sums may flip its sign, so those elements are held to 2*lr
    and the rest to 1e-5."""
    monkeypatch.setattr(mnist, "DTYPE", torch.float32)
    lr = 1e-3
    params = mnist.init(7)
    x, y = mnist.batch_fn(8)
    batch = (x[:8], y[:8])
    out = {}
    for where in ("cpu", cuda):
        p = common.to_device(params, where)
        b = common.to_device(batch, where)
        _, grads = common.value_and_grad(mnist.loss_fn, p, b)
        opt = tfa.fused_adam(lr)
        p, _, loss = common.make_train_step(mnist.loss_fn, opt)(
            p, opt.init(p), b)
        out[str(where)] = (float(loss),
                           [t.cpu().numpy() for t in tree_leaves(p)],
                           [t.cpu().numpy() for t in tree_leaves(grads)])
    (lc, pc, gc), (lg, pg, _) = out["cpu"], out[str(cuda)]
    assert lg == pytest.approx(lc, rel=1e-5)
    for a, b, g in zip(pc, pg, gc):
        np.testing.assert_allclose(b, a, atol=2 * lr + 1e-6, rtol=0)
        firm = np.abs(g) > 1e-4
        np.testing.assert_allclose(b[firm], a[firm], atol=1e-5, rtol=0)


# --- flash attention ---------------------------------------------------------

def _qkv(cuda, b, s, h, hk, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    make = lambda heads: torch.from_numpy(rng.standard_normal(
        (b, s, heads, d)).astype(np.float32)).to(cuda, dtype)
    return make(h), make(hk), make(hk)


def _fused_qkv(cuda, b, s, h, hk, d, dtype, pad=0, seed=0):
    """q, k, v as strided views of one (b, s, (h + 2 hk) d + pad) tensor,
    sliced as mha_apply slices the fused qkv product; an odd ``pad`` makes
    the rows not 16-byte aligned."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal(
        (b, s, (h + 2 * hk) * d + pad)).astype(np.float32)).to(cuda, dtype)
    q = qkv[..., :h * d].reshape(b, s, h, d)
    k = qkv[..., h * d:(h + hk) * d].reshape(b, s, hk, d)
    v = qkv[..., (h + hk) * d:(h + 2 * hk) * d].reshape(b, s, hk, d)
    return q, k, v


def _assert_kernel_close(got, want):
    atol, rtol = tfl.KERNEL_TOL[got.dtype]
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


FLASH_SHAPES = [
    # (b, s, h, hk, d, dtype, causal, window, layout): layout "fused" makes
    # q, k, v strided views of one tensor with 16-byte aligned rows,
    # "unaligned" with rows that are not (the bf16 kernels' plain loads)
    (8, 256, 8, 8, 32, torch.bfloat16, True, None, "dense"),  # main path
    (8, 256, 8, 2, 32, torch.bfloat16, True, None, "dense"),  # GQA
    (8, 256, 8, 2, 32, torch.bfloat16, True, None, "fused"),
    (8, 256, 8, 2, 32, torch.bfloat16, True, None, "unaligned"),
    (8, 256, 8, 8, 32, torch.bfloat16, True, 100, "dense"),   # window
    (8, 256, 8, 8, 32, torch.bfloat16, False, None, "dense"),
    (8, 256, 8, 8, 32, torch.float32, True, None, "dense"),
    (2, 48, 4, 1, 8, torch.float32, True, 7, "dense"),   # ragged tiles, MQA
    (1, 80, 2, 2, 8, torch.bfloat16, False, None, "dense"),
    (2, 128, 4, 2, 8, torch.bfloat16, True, None, "dense"),  # small preset
    (2, 128, 4, 2, 8, torch.bfloat16, True, None, "unaligned"),
    (2, 48, 4, 1, 8, torch.bfloat16, True, 7, "dense"),   # ragged, bf16
    (2, 48, 4, 2, 32, torch.bfloat16, True, None, "dense"),
    (1, 80, 2, 2, 32, torch.bfloat16, False, None, "dense"),
    (1, 200, 4, 4, 32, torch.bfloat16, True, 70, "dense"),  # ragged, window
    (1, 200, 4, 2, 32, torch.bfloat16, True, 70, "unaligned"),
    # the wide head dims: GPT-2's 64 and Llama's 128, every instance (bf16
    # with cp.async and with plain loads, fp32)
    (8, 256, 8, 8, 64, torch.bfloat16, True, None, "dense"),
    (8, 256, 8, 2, 64, torch.bfloat16, True, 100, "fused"),
    (1, 200, 4, 2, 64, torch.bfloat16, True, 70, "unaligned"),
    (2, 80, 8, 8, 64, torch.float32, True, None, "dense"),
    (8, 256, 8, 8, 128, torch.bfloat16, True, None, "dense"),
    (8, 256, 8, 2, 128, torch.bfloat16, True, None, "unaligned"),
    (1, 200, 4, 2, 128, torch.bfloat16, True, 70, "dense"),
    (1, 80, 2, 2, 128, torch.bfloat16, False, None, "fused"),
    (2, 80, 8, 8, 128, torch.float32, True, 7, "dense"),
    # the instances 16 and 256 (256 with Gemma-2B's one kv head)
    (8, 256, 8, 8, 16, torch.bfloat16, True, None, "dense"),
    (2, 80, 4, 2, 16, torch.bfloat16, True, 7, "unaligned"),
    (2, 80, 8, 8, 16, torch.float32, True, None, "dense"),
    (8, 256, 8, 8, 256, torch.bfloat16, True, None, "dense"),
    (8, 256, 8, 1, 256, torch.bfloat16, True, None, "fused"),
    (1, 200, 4, 2, 256, torch.bfloat16, True, 70, "unaligned"),
    (2, 80, 8, 8, 256, torch.float32, True, 7, "dense"),
    # head dims between the instances, on the wider one's zero columns
    (2, 80, 4, 2, 20, torch.bfloat16, True, None, "dense"),
    (1, 48, 2, 1, 5, torch.bfloat16, True, None, "dense"),
    (8, 256, 8, 8, 80, torch.bfloat16, True, None, "fused"),
    (1, 200, 4, 2, 96, torch.bfloat16, True, 70, "unaligned"),
    (1, 64, 2, 2, 33, torch.bfloat16, False, None, "unaligned"),
    (8, 256, 8, 2, 200, torch.bfloat16, True, None, "dense"),
    (2, 80, 8, 8, 80, torch.float32, True, None, "dense"),
    (1, 64, 2, 2, 129, torch.float32, False, None, "dense"),
]


@pytest.mark.parametrize("b,s,h,hk,d,dtype,causal,window,layout",
                         FLASH_SHAPES)
def test_flash_kernels_match_plain_on_card(cuda, b, s, h, hk, d, dtype,
                                           causal, window, layout):
    """Each pass against its plain version. dO is random fp32, not exact
    in bf16, so the bf16 kernels' split of dO into hi and lo parts is
    exercised (on the main path dO is the gradient of a bf16 cast)."""
    if layout == "dense":
        q, k, v = _qkv(cuda, b, s, h, hk, d, dtype)
    else:
        q, k, v = _fused_qkv(cuda, b, s, h, hk, d, dtype,
                             pad=int(layout == "unaligned"))
        assert not q.is_contiguous()
    dout = torch.randn(b, s, h, d, device=cuda)
    assert not torch.equal(dout, dout.to(torch.bfloat16).float())
    scale = 1.0 / np.sqrt(d)
    before = dict(tfl.launches)
    o, lse = tfl.flash_fwd(q, k, v, causal, window, scale)
    ro, rlse = tfl.flash_fwd_reference(q, k, v, causal, window, scale)
    _assert_kernel_close(o, ro)
    _assert_kernel_close(lse, rlse)
    dcap = (dout * ro).sum(-1).transpose(1, 2)
    bwd = (q, k, v, dout, rlse, dcap, causal, window, scale)
    # the wide bf16 passes read dO's parts and flags from the prologue
    wide = tfl._takes_split(q)
    extra = tfl.flash_prep(dout, ro, None)[:2] if wide else ()
    dq = tfl.flash_dq(*bwd, *extra)
    dk, dv = tfl.flash_dkv(*bwd, *extra)
    rdq = tfl.flash_dq_reference(*bwd)
    rdk, rdv = tfl.flash_dkv_reference(*bwd)
    torch.cuda.synchronize()
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        _assert_kernel_close(got, want)
    assert {n: tfl.launches[n] - before[n] for n in before} == \
        {"fwd": 1, "dq": 1, "dkv": 1, "prep": int(wide)}


def test_flash_fwd_long_sequence_on_card(cuda):
    """Seq 2048: 32 k tiles for the last q tile, launched first."""
    q, k, v = _qkv(cuda, 1, 2048, 8, 8, 32, torch.bfloat16, seed=3)
    o, lse = tfl.flash_fwd(q, k, v, True, None, 32 ** -0.5)
    ro, rlse = tfl.flash_fwd_reference(q, k, v, True, None, 32 ** -0.5)
    _assert_kernel_close(o, ro)
    _assert_kernel_close(lse, rlse)


def test_flash_bf16_autograd_on_card_matches_plain(cuda):
    """flash_attention through autograd on bf16 strided views at the main
    path's shape: the kernel forward's lse feeds the backward kernels.
    Held against the plain versions on the same inputs: O to the fp32
    tolerance, the gradients to the bf16 one."""
    b, s, h, d = 8, 256, 8, 32
    rng = np.random.default_rng(9)
    fused = torch.from_numpy(rng.standard_normal(
        (b, s, 3 * h * d)).astype(np.float32)).to(cuda, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32)).to(cuda)
    f = fused.clone().requires_grad_(True)
    views = lambda x: [x[..., i * h * d:(i + 1) * h * d].reshape(b, s, h, d)
                       for i in range(3)]
    before = dict(tfl.launches)
    o = tfl.flash_attention(*views(f))
    (o * w).sum().backward()
    assert {n: tfl.launches[n] - before[n] for n in before} == \
        {"fwd": 1, "dq": 1, "dkv": 1, "prep": 0}
    q, k, v = views(fused)
    scale = d ** -0.5
    ro, rlse = tfl.flash_fwd_reference(q, k, v, True, None, scale)
    dcap = (w * ro).sum(-1).transpose(1, 2)
    args = (q, k, v, w, rlse, dcap, True, None, scale)
    rdq = tfl.flash_dq_reference(*args)
    rdk, rdv = tfl.flash_dkv_reference(*args)
    torch.cuda.synchronize()
    _assert_kernel_close(o.detach(), ro)
    for got, want in zip(views(f.grad), (rdq, rdk, rdv)):
        _assert_kernel_close(got, want)


@pytest.mark.parametrize("dtype,kernels", [
    (torch.bfloat16, ("flash_fwd_mma_kernel", "flash_dq_mma_kernel",
                      "flash_dkv_mma_kernel")),
    (torch.float32, ("flash_fwd_kernel", "flash_dq_kernel",
                     "flash_dkv_kernel"))], ids=["bf16", "fp32"])
def test_flash_picks_its_kernels_by_dtype_on_card(cuda, dtype, kernels):
    """bf16 inputs run only the tensor-core kernels, fp32 inputs only the
    CUDA-core ones, read from the profiler's kernel names. The profiler
    warms up on a first call and records the next two, and the names are
    read when that trace is ready: a profile of a lone call listed no
    forward kernel once, and a lone recorded call after a warm-up step
    missed it in the first of ten runs on a fresh machine."""
    from torch.profiler import ProfilerActivity, profile, schedule

    q, k, v = (t.requires_grad_(True) for t in
               _qkv(cuda, 2, 128, 4, 2, 32, dtype))
    tfl.flash_attention(q, k, v).sum().backward()   # built and warm
    names: set = set()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=2, repeat=1),
                 on_trace_ready=lambda p: names.update(
                     e.key for e in p.key_averages()
                     if "flash_" in e.key)) as prof:
        for _ in range(3):
            tfl.flash_attention(q, k, v).sum().backward()
            torch.cuda.synchronize()
            prof.step()
    ran = {n.split("<")[0].split("::")[-1] for n in names}
    assert ran == set(kernels), names


def test_flash_autograd_on_card_matches_cpu(cuda):
    """flash_attention_lse through autograd on strided views of one fused
    product (the transformer's layout), card against CPU, fp32."""
    rng = np.random.default_rng(5)
    fused = rng.standard_normal((2, 64, 8 * 8 + 2 * 2 * 8)).astype(
        np.float32)
    w = torch.from_numpy(rng.standard_normal((2, 64, 8, 8)).astype(
        np.float32))
    out = {}
    for where in ("cpu", cuda):
        f = torch.tensor(fused, device=where, requires_grad=True)
        q = f[..., :64].reshape(2, 64, 8, 8)
        k = f[..., 64:80].reshape(2, 64, 2, 8)
        v = f[..., 80:].reshape(2, 64, 2, 8)
        o, lse = tfl.flash_attention_lse(q, k, v, block_q=32, block_k=32,
                                         window=20)
        ((o * w.to(where)).sum() + torch.sin(lse).sum()).backward()
        out[str(where)] = (o.detach().cpu(), f.grad.cpu())
    for a, b in zip(out["cpu"], out[str(cuda)]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


def test_flash_refuses_what_the_kernels_do_not_take(cuda):
    """Head dims past 256 raise on the card, naming the limit (no fallback
    to the plain version, nothing launched); 16, 64, 128, 256 and a head
    dim between instances run their kernels."""
    for d in (257, 512):
        q, k, v = _qkv(cuda, 1, 32, 2, 2, d, torch.float32)
        before = dict(tfl.launches)
        with pytest.raises(ValueError, match="1 to 256"):
            tfl.flash_attention(q, k, v)
        assert tfl.launches == before
    for d in (16, 64, 80, 128, 256):
        q, k, v = _qkv(cuda, 1, 32, 2, 2, d, torch.float32)
        before = tfl.launches["fwd"]
        o = tfl.flash_attention(q, k, v)
        assert tfl.launches["fwd"] == before + 1
        _assert_kernel_close(o, tfl.flash_fwd_reference(
            q, k, v, True, None, d ** -0.5)[0])
    q, k, v = _qkv(cuda, 1, 32, 2, 2, 32, torch.float16)
    with pytest.raises(TypeError):
        tfl.flash_attention(q, k, v)


# the wide bf16 backward (csrc/flash_backward_wide.cuh): (b, s, h, hk, d,
# window, layout, dO exact in bf16); "unaligned" views take the plain-load
# instance, the rest TMA
WIDE_BWD_CASES = [
    (8, 256, 8, 8, 64, None, "dense", True),      # the LM at dim 512
    (8, 256, 8, 8, 128, None, "dense", True),     # the LM at dim 1024
    (8, 256, 8, 8, 64, None, "dense", False),     # a nonzero lo part
    (8, 256, 8, 8, 128, None, "fused", False),
    (8, 256, 8, 2, 128, None, "dense", True),     # GQA
    (8, 256, 8, 2, 64, 100, "fused", False),      # GQA, window
    (8, 256, 8, 8, 128, 128, "dense", True),      # window
    (2, 80, 8, 8, 128, None, "dense", False),     # ragged
    (1, 200, 4, 2, 64, 70, "dense", True),
    (1, 200, 4, 2, 128, 70, "unaligned", False),  # plain loads
    (8, 256, 8, 2, 64, None, "unaligned", True),
    (1, 2048, 8, 2, 128, 1024, "dense", True),    # seq 2048
    (8, 256, 8, 1, 256, None, "dense", True),     # Gemma-2B's attention
    (2, 80, 8, 8, 256, None, "fused", False),
    (1, 200, 4, 2, 256, 70, "unaligned", False),
    (8, 256, 8, 8, 80, None, "fused", True),      # Phi-2's, on 128
    (1, 200, 4, 2, 96, 70, "dense", False),
    (2, 80, 4, 2, 200, None, "unaligned", False),
]


@pytest.mark.parametrize("b,s,h,hk,d,window,layout,exact", WIDE_BWD_CASES)
def test_wide_backward_matches_plain_on_card(cuda, b, s, h, hk, d, window,
                                             layout, exact):
    """The bf16 backward from head dim 33 through autograd, with a
    nonzero lse cotangent: the prologue's D, parts and flags (against its
    plain version: parts and flags exactly, D at the fp32 tolerance), then
    dQ, dK and dV against the plain passes at KERNEL_TOL, dO exact in bf16
    (the lo products skipped) or not. One launch of each pass."""
    if layout == "dense":
        q, k, v = _qkv(cuda, b, s, h, hk, d, torch.bfloat16)
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        inputs, grads = leaves, lambda: [x.grad for x in leaves]
    else:
        # views of one leaf, as mha_apply gives them (rows 16-byte aligned
        # or, with the pad, not)
        q, k, v = _fused_qkv(cuda, b, s, h, hk, d, torch.bfloat16,
                             pad=int(layout == "unaligned"))
        fused = q._base.clone().requires_grad_(True)
        cut = (0, h * d, (h + hk) * d, (h + 2 * hk) * d)
        views = lambda x: [x[..., cut[i]:cut[i + 1]].reshape(
            b, s, heads, d) for i, heads in enumerate((h, hk, hk))]
        inputs, grads = views(fused), lambda: views(fused.grad)
        assert not inputs[0].is_contiguous()
    g = torch.randn(b, s, h, d, device=cuda)
    if exact:
        g = g.to(torch.bfloat16).float()
    g_lse = torch.randn(b, s, h, device=cuda)
    before = dict(tfl.launches)
    # blocks of 8 divide every case's length (the kernels tile on their own)
    o, lse = tfl.flash_attention_lse(*inputs, block_q=8, block_k=8,
                                     window=window)
    ((o * g).sum() + (lse * g_lse).sum()).backward()
    torch.cuda.synchronize()
    assert {n: tfl.launches[n] - before[n] for n in before} == \
        {"fwd": 1, "dq": 1, "dkv": 1, "prep": 1}
    scale = 1.0 / np.sqrt(d)
    split, lo_live, dcap = tfl.flash_prep(g, o.detach(), g_lse)
    rsplit, rlive, rdcap = tfl.flash_prep_reference(g, o.detach(), g_lse)
    assert torch.equal(split, rsplit) and torch.equal(lo_live, rlive)
    assert int(lo_live.sum()) == (0 if exact else lo_live.numel())
    _assert_kernel_close(dcap, rdcap)
    ro, rlse = tfl.flash_fwd_reference(q, k, v, True, window, scale)
    want_dcap = ((g * ro).sum(-1) - g_lse).transpose(1, 2)
    args = (q, k, v, g, rlse, want_dcap, True, window, scale)
    want = (tfl.flash_dq_reference(*args), *tfl.flash_dkv_reference(*args))
    for got, ref in zip(grads(), want):
        _assert_kernel_close(got, ref)


def test_wide_backward_runs_the_wgmma_kernels_on_card(cuda):
    """bf16 at the instances 64, 128 and 256 runs the wgmma forward, backward
    passes and the prologue, and no mma.sync kernel, read from the
    profiler's kernel names (warmed up first, as the dtype test does)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for d in tfl.WIDE_HEAD_DIMS:
        q, k, v = (t.requires_grad_(True) for t in
                   _qkv(cuda, 2, 128, 4, 2, d, torch.bfloat16))
        tfl.flash_attention(q, k, v).sum().backward()
        names: set = set()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=2, repeat=1),
                     on_trace_ready=lambda p: names.update(
                         e.key for e in p.key_averages()
                         if "flash_" in e.key)) as prof:
            for _ in range(3):
                tfl.flash_attention(q, k, v).sum().backward()
                torch.cuda.synchronize()
                prof.step()
        ran = {n.split("<")[0].split("::")[-1] for n in names}
        assert ran == {"flash_fwd_wgmma_kernel", "flash_prep_kernel",
                       "flash_dq_wgmma_kernel", "flash_dkv_wgmma_kernel"}, \
            names


# the wide bf16 forward (csrc/flash_forward_wide.cuh): (b, s_q, s_kv, h,
# hk, d, causal, window, layout); "unaligned" views take the plain-load
# instance, the rest TMA
WIDE_FWD_CASES = [
    (8, 256, 256, 8, 8, 64, True, None, "dense"),     # the LM at dim 512
    (8, 256, 256, 8, 8, 128, True, None, "dense"),    # the LM at dim 1024
    (8, 256, 256, 8, 2, 128, True, 128, "fused"),     # GQA, window
    (8, 256, 256, 8, 2, 64, True, 100, "unaligned"),  # plain loads
    (1, 200, 200, 4, 2, 128, True, 70, "unaligned"),  # ragged
    (2, 200, 200, 8, 8, 64, True, None, "dense"),
    (2, 50, 50, 4, 1, 128, True, None, "dense"),      # one consumer's rows
    (1, 160, 200, 8, 2, 128, False, None, "dense"),   # s_q != s_kv
    (2, 130, 96, 4, 2, 64, False, None, "dense"),
    (1, 2048, 2048, 8, 2, 128, True, 1024, "dense"),  # seq 2048
    (8, 256, 256, 8, 1, 256, True, None, "dense"),    # Gemma-2B's
    (2, 50, 50, 4, 1, 256, True, None, "fused"),
    (1, 160, 200, 8, 2, 256, False, None, "unaligned"),
    (2, 200, 200, 8, 8, 96, True, None, "fused"),     # on 128
    (1, 130, 96, 4, 2, 80, False, None, "unaligned"),
    (2, 130, 130, 4, 2, 40, True, 50, "dense"),       # on 64
]


@pytest.mark.parametrize("b,s_q,s_kv,h,hk,d,causal,window,layout",
                         WIDE_FWD_CASES)
def test_wide_forward_matches_plain_on_card(cuda, b, s_q, s_kv, h, hk, d,
                                            causal, window, layout):
    """The bf16 forward from head dim 33, O and the lse against the
    plain forward at KERNEL_TOL, on TMA and on plain loads: ragged lengths
    (not a multiple of the block's 128 rows), s_q != s_kv, GQA and
    windows. One launch."""
    if layout == "dense":
        q = _qkv(cuda, b, s_q, h, hk, d, torch.bfloat16)[0]
        _, k, v = _qkv(cuda, b, s_kv, h, hk, d, torch.bfloat16, seed=1)
    else:
        q, k, v = _fused_qkv(cuda, b, s_q, h, hk, d, torch.bfloat16,
                             pad=int(layout == "unaligned"))
        assert not q.is_contiguous()
    scale = 1.0 / np.sqrt(d)
    before = dict(tfl.launches)
    o, lse = tfl.flash_fwd(q, k, v, causal, window, scale)
    ro, rlse = tfl.flash_fwd_reference(q, k, v, causal, window, scale)
    torch.cuda.synchronize()
    assert {n: tfl.launches[n] - before[n] for n in before} == \
        {"fwd": 1, "dq": 0, "dkv": 0, "prep": 0}
    _assert_kernel_close(o, ro)
    _assert_kernel_close(lse, rlse)


def test_wide_backward_refuses_parts_that_do_not_fit(cuda):
    """dO's parts and flags given to a pass are checked, and a pass given
    dO alone refuses; nothing launches the prologue on its own or falls
    back to the plain version."""
    q, k, v = _qkv(cuda, 1, 64, 2, 2, 64, torch.bfloat16)
    dout = torch.randn(1, 64, 2, 64, device=cuda)
    o, lse = tfl.flash_fwd(q, k, v, True, None, 0.125)
    split, lo_live, dcap = tfl.flash_prep(dout, o, None)
    bwd = (q, k, v, dout, lse, dcap, True, None, 0.125)
    before = dict(tfl.launches)
    for call in (tfl.flash_dq, tfl.flash_dkv):
        with pytest.raises(ValueError, match="dout_split"):
            call(*bwd)
        with pytest.raises(ValueError, match="dout_split"):
            call(*bwd, split, None)
    assert tfl.launches == before
    with pytest.raises(ValueError, match="dout_split"):
        tfl.flash_dq(*bwd, split[:, :, :32].contiguous(), lo_live)
    with pytest.raises(ValueError, match="dout_split"):
        tfl.flash_dkv(*bwd, split, lo_live.to(torch.int64))


# --- the kernels as custom ops, and an exported train step ------------------

def test_custom_ops_on_card_equal_their_plain_versions(cuda):
    """Each op through the dispatcher, at the main path's shapes: the CUDA
    implementation is the kernel (it counts its launch), held to its plain
    version at chip_smoke.py's tolerances."""
    ops = torch.ops.kubeshare_tpu_torch
    q, k, v = _qkv(cuda, 8, 256, 8, 8, 32, torch.bfloat16)
    scale = 32 ** -0.5
    before = dict(tfl.launches)
    o, lse = ops.flash_fwd(q, k, v, True, None, scale)
    ro, rlse = tfl.flash_fwd_reference(q, k, v, True, None, scale)
    _assert_kernel_close(o, ro)
    _assert_kernel_close(lse, rlse)
    dout = torch.randn(o.shape, device=cuda)
    dcap = (dout * ro).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, dout, rlse, dcap, True, None, scale)
    _assert_kernel_close(ops.flash_dq(*bwd), tfl.flash_dq_reference(*bwd))
    for got, want in zip(ops.flash_dkv(*bwd), tfl.flash_dkv_reference(*bwd)):
        _assert_kernel_close(got, want)
    assert {n: tfl.launches[n] - before[n] for n in before} == \
        {"fwd": 1, "dq": 1, "dkv": 1, "prep": 0}
    rng = np.random.default_rng(5)
    shapes = [(3136, 256), (256,), (8, 128)]
    host = [[rng.normal(size=s).astype(np.float32) for s in shapes]
            for _ in range(4)]
    host[3] = [np.abs(a) for a in host[3]]
    kern = [[torch.from_numpy(a).to(cuda) for a in xs] for xs in host]
    plain = [[t.clone() for t in xs] for xs in kern]
    step = torch.tensor(3.0, device=cuda)
    launched = tfa.launches
    ops.fused_adam(*kern, step, 1e-2, 0.9, 0.999, 1e-8)
    for p, g, m, v in zip(*plain):
        tfa.adam_update_reference(p, g, m, v, step, 1e-2)
    torch.cuda.synchronize()
    assert tfa.launches == launched + 1
    for got, want in zip(kern[0] + kern[2] + kern[3],
                         plain[0] + plain[2] + plain[3]):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def _lm_step_inputs(cuda, seed=3):
    params = common.to_device(transformer.init(seed), cuda)
    opt = tfa.fused_adam(1e-3)
    return (params, opt.init(params),
            common.to_device(transformer.batch_fn(seed + 1), cuda)), opt


def test_a_fake_trace_of_the_lm_step_records_the_ops_and_runs_nothing(
        cuda, monkeypatch):
    """The full-width LM step traced on fake CUDA tensors: the graph holds
    4 of each flash op (4 layers) and 1 fused Adam op, and no kernel is
    built or launched — the ctypes entry points are not reached."""
    from kubeshare_tpu_torch.isolation import exported

    def refuse():
        raise AssertionError("a ctypes kernel was reached while tracing")

    monkeypatch.setattr(tfa, "_kernel_fn", refuse)
    monkeypatch.setattr(tfl, "_kernel_fns", refuse)
    args, opt = _lm_step_inputs(cuda)
    step = common.make_train_step(transformer.flash_loss_fn, opt)
    before = (tfa.launches, dict(tfl.launches))
    blob, _, _, out_meta = exported.export_program(step, args, cuda)
    assert (tfa.launches, dict(tfl.launches)) == before
    prog = exported.load_program(blob, cuda)
    ops = [str(n.target) for n in prog._module.graph.nodes]
    assert [ops.count(f"kubeshare_tpu_torch.{k}.default") for k in
            ("flash_fwd", "flash_dq", "flash_dkv", "fused_adam")] == \
        [transformer.LAYERS] * 3 + [1]
    assert list(out_meta[-1]) == [[], "float32"]


def test_the_exported_lm_step_on_card_gives_the_eager_step(cuda):
    """The full-width LM step exported, loaded on the card and run against
    the eager step on copies of the same inputs: the same aten ops and
    kernels in the same order, so the loss and every parameter are equal
    bit for bit. The kernels launch from the loaded graph."""
    from kubeshare_tpu_torch.isolation import exported

    args, opt = _lm_step_inputs(cuda)
    step = common.make_train_step(transformer.flash_loss_fn, opt)
    blob, _, out_def, _ = exported.export_program(step, args, cuda)
    prog = exported.load_program(blob, cuda)
    leaves = [t.clone() for t in tree_leaves(args)]
    before = (tfa.launches, tfl.launches["fwd"])
    outs = prog(*leaves)
    torch.cuda.synchronize()
    assert (tfa.launches - before[0], tfl.launches["fwd"] - before[1]) == \
        (1, transformer.LAYERS)
    params, state, loss = step(*args)
    assert outs[0] is leaves[0]              # Adam updated in place
    assert float(outs[-1]) == float(loss)
    for got, want in zip(outs[:-1], tree_leaves((params, state))):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# --- gate-mode attach on the card --------------------------------------------

REPO = Path(__file__).resolve().parent.parent
SHIM = REPO / "kubeshare_tpu_torch" / "_shim"


@pytest.fixture
def token_server(cuda):
    from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler, serve

    sched = TokenScheduler(window_ms=120000, base_quota_ms=30000,
                           min_quota_ms=10)
    server = serve(sched)
    yield sched, server.server_address[1]
    from kubeshare_tpu_torch import attach
    attach.detach()
    server.shutdown()
    server.server_close()
    sched.close()


def _device_ms(fn) -> float:
    """Device time of ``fn()``'s launches, by CUDA events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


@pytest.mark.parametrize("work", ["sleep", "flash"])
def test_gate_charges_real_device_time_on_card(token_server, work):
    """Kernels the meter cannot see — ``torch.cuda._sleep`` and the flash
    kernels, launched through ctypes, queue asynchronously — are charged
    their device time through the gate's drain of the device queue (the
    JAX package's test_gate_charges_real_device_duration bar: at least
    0.6x the measured duration)."""
    from kubeshare_tpu_torch import attach

    sched, port = token_server
    if work == "sleep":
        fn = lambda: [torch.cuda._sleep(50_000_000) for _ in range(6)]
    else:
        q, k, v = _qkv(torch.device("cuda"), 1, 8192, 8, 8, 32,
                       torch.bfloat16)
        fn = lambda: [tfl.flash_fwd(q, k, v, True, None, 32 ** -0.5)
                      for _ in range(600)]
    fn()
    ref_ms = _device_ms(fn)
    assert ref_ms > 100, f"too short to discriminate: {ref_ms} ms"
    before = dict(tfl.launches)
    attach.attach_gate("127.0.0.1", port, "devicepod", 0.5, 1.0)
    torch.ones(1, device="cuda")   # the first op acquires
    fn()                           # queued; the launches return at once
    attach.detach()                # the release drains and charges
    used = sched.window_usage("devicepod")
    assert used >= 0.6 * ref_ms, (used, ref_ms)
    if work == "flash":
        assert tfl.launches["fwd"] - before["fwd"] == 600


def test_gate_meters_backward_on_the_autograd_device_thread(token_server,
                                                            monkeypatch):
    """On the card, backward runs on the autograd engine's device thread;
    its ops pass the meter all the same (the engine carries the dispatch
    mode in its thread-local state)."""
    import threading

    from kubeshare_tpu_torch import attach
    from kubeshare_tpu_torch.isolation.client import ExecutionGate

    threads = []
    real = ExecutionGate.__call__
    monkeypatch.setattr(
        ExecutionGate, "__call__",
        lambda self: (threads.append(threading.current_thread().name),
                      real(self)))
    _, port = token_server
    attach.attach_gate("127.0.0.1", port, "bwd", 0.5, 1.0)
    x = torch.ones(64, 64, device="cuda", requires_grad=True)
    y = (x @ x).sum()
    n = len(threads)
    y.backward()
    torch.cuda.synchronize()
    attach.detach()
    assert len(threads) > n
    assert any(t != "MainThread" for t in threads[n:]), threads[n:]


def _pod_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KUBESHARE_TPU_") and k not in (
               "TPU_VISIBLE_CHIPS", "CUDA_VISIBLE_DEVICES")}
    env["PYTHONPATH"] = os.pathsep.join([str(SHIM), str(REPO)])
    env.update({k: str(v) for k, v in extra.items()})
    return env


def test_memory_cap_kills_tenant_cotenant_keeps_acquiring(token_server,
                                                          tmp_path):
    """A gated tenant whose ``memory_reserved`` passes its grant dies with
    an attributable error; its co-tenant keeps acquiring the token."""
    from kubeshare_tpu_torch.isolation import protocol
    from kubeshare_tpu_torch.isolation.podmgr import PodManager

    sched, port = token_server
    mgrs = [PodManager("127.0.0.1", port, name, 0.5, 1.0)
            for name in ("ns/hog", "ns/cotenant")]
    for m in mgrs:
        m.serve()
    script = tmp_path / "hog.py"
    script.write_text("""
import time, torch
held = []
for _ in range(64):
    held.append(torch.empty(64 << 20, dtype=torch.uint8, device="cuda"))
    time.sleep(0.05)
print("UNREACHABLE: cap never fired")
""")
    try:
        hog = subprocess.Popen(
            [sys.executable, str(script)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=_pod_env(KUBESHARE_TPU_POD_MANAGER_PORT=mgrs[0].port,
                         KUBESHARE_TPU_POD_NAME="ns/hog",
                         KUBESHARE_TPU_REQUEST="0.5",
                         KUBESHARE_TPU_MEM=256 << 20))
        conn = protocol.Connection("127.0.0.1", mgrs[1].port)
        grants = 0
        while hog.poll() is None:
            conn.call({"op": "acquire"})
            time.sleep(0.01)
            conn.call({"op": "release", "used_ms": 10.0})
            grants += 1
        out, err = hog.communicate(timeout=120)
        assert hog.returncode != 0, out
        assert "device memory cap exceeded" in err, err[-2000:]
        assert "UNREACHABLE" not in out
        for _ in range(3):             # the co-tenant goes on acquiring
            conn.call({"op": "acquire"})
            conn.call({"op": "release", "used_ms": 1.0})
        assert grants > 0
        conn.close()
    finally:
        for m in mgrs:
            m.close()


def test_shim_pins_the_grant_as_cuda_visible_devices(token_server):
    """A tenant attached through the shim sees only the device of its
    chip grant: the pin sets CUDA_VISIBLE_DEVICES before CUDA
    initializes."""
    from kubeshare_tpu_torch.isolation.podmgr import PodManager
    from kubeshare_tpu_torch.topology.discovery import discover_chips

    sched, port = token_server
    chip = discover_chips("cuda", host="node")[-1]
    mgr = PodManager("127.0.0.1", port, "ns/pinned", 0.5, 1.0)
    mgr.serve()
    try:
        proc = subprocess.run(
            [sys.executable, "-c",
             "import os, torch; from kubeshare_tpu_torch import attach; "
             "print(attach.active_mode(), os.environ['CUDA_VISIBLE_DEVICES'],"
             " torch.cuda.device_count(), float(torch.ones(2, "
             "device='cuda').sum()))"],
            capture_output=True, text=True, timeout=120, cwd=str(REPO),
            env=_pod_env(KUBESHARE_TPU_POD_MANAGER_PORT=mgr.port,
                         KUBESHARE_TPU_POD_NAME="ns/pinned",
                         KUBESHARE_TPU_REQUEST="0.5",
                         TPU_VISIBLE_CHIPS=chip.chip_id))
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert proc.stdout.split() == ["gate", str(chip.index), "1", "2.0"]
        assert sched.window_usage("ns/pinned") > 0.0
    finally:
        mgr.close()


# --- the proxy's session journal and pipelined wire on the card --------------

def _card_proxy(cuda, journal_dir=None):
    from kubeshare_tpu_torch.isolation.proxy import ChipProxy
    from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler

    p = ChipProxy(device=cuda, scheduler=TokenScheduler(1000.0, 100.0, 10.0),
                  journal_dir=journal_dir)
    p.serve()
    return p


def test_a_journaled_session_on_card_restores_to_equal_tensors(cuda,
                                                               tmp_path):
    """A session on the card — an in-place Adam step run twice, a bfloat16
    output beside it — is journaled, the proxy crashes, and a new proxy
    restores every buffer from the journal to a tensor equal to the one
    the crashed proxy held, on the card, handles that named one tensor
    naming one again."""
    from kubeshare_tpu_torch.isolation.client import ProxyClient

    def step(p, g, m, v, count):
        count.add_(1.0)
        tfa.adam_update(p, g, m, v, count, lr=1e-2)
        return p, m, v, count, p.to(torch.bfloat16)

    p1 = _card_proxy(cuda, str(tmp_path))
    c = ProxyClient("127.0.0.1", p1.port, "journaled", 0.5, 1.0)
    rng = np.random.default_rng(0)
    bufs = [c.put(rng.standard_normal((64, 32)).astype(np.float32))
            for _ in range(2)]
    bufs += [c.put(np.zeros((64, 32), np.float32)) for _ in range(2)]
    bufs.append(c.put(np.zeros((), np.float32)))
    exe = c.compile(step, *bufs)
    for _ in range(2):
        out = exe(*bufs)
    held = {h: t.clone() for h, t in p1._sessions["journaled"].buffers.items()}
    assert any(t.dtype == torch.bfloat16 for t in held.values())
    p1.crash(wait=True)
    p2 = _card_proxy(cuda, str(tmp_path))
    try:
        sess = p2._sessions["journaled"]
        assert set(sess.buffers) == set(held)
        for h, t in held.items():
            got = sess.buffers[h]
            assert got.device.type == cuda.type and got.dtype == t.dtype
            assert torch.equal(got, t), h
        assert sess.buffers[out[0].handle] is sess.buffers[bufs[0].handle]
        assert p2.hbm_accounting()["journaled"]["balanced"]
    finally:
        p2.close()
        p1.close()


def test_the_pipelined_execute_works_on_card(cuda):
    """On the card, many executes ride the pipelined wire at once and each
    future resolves to its own step's result, in submission order."""
    from kubeshare_tpu_torch.isolation.client import ProxyClient, RemoteBuffer

    p = _card_proxy(cuda)
    c = ProxyClient("127.0.0.1", p.port, "pipelined", 0.5, 1.0)
    try:
        assert {"seq", "resume"} <= c.features
        x = c.put(np.arange(1024, dtype=np.float32))
        exe = c.compile(lambda t, k: t * k, x, np.float32(1.0))
        ks = [c.put(np.float32(k)) for k in range(16)]
        futs = [c.execute_async(exe._exec_id, [x.handle, k.handle])
                for k in ks]
        outs = [f.result() for f in futs]
        for k, (h,) in enumerate(outs):
            got = c.get(RemoteBuffer(h, (1024,), "float32"))
            np.testing.assert_array_equal(got, k * np.arange(1024))
        assert p._sessions["pipelined"].exec_count == 16
    finally:
        c.close()
        p.close()


# --- index guards, factory ops, the native core and serving on the card ------

def test_an_out_of_range_index_leaves_the_proxy_running_on_card(cuda):
    """A tenant's loaded program reads and updates with indices out of
    range on the card: no device-side assert (which would end the proxy's
    CUDA context for every tenant) — reads clamp or fill, updates drop —
    and a second tenant's next step still runs, right."""
    from kubeshare_tpu_torch.isolation.client import ProxyClient

    def bad(t, i, logp, lab):
        t = t.detach().requires_grad_(True)
        rows = t[i]
        nll = -torch.gather(logp, -1, lab.unsqueeze(-1)).squeeze(-1)
        (grad,) = torch.autograd.grad(rows.sum(), t)
        return rows, nll, grad, t.new_zeros(3, 2).index_add(0, i, rows)

    p = _card_proxy(cuda)
    a = ProxyClient("127.0.0.1", p.port, "reckless", 0.5, 1.0)
    b = ProxyClient("127.0.0.1", p.port, "bystander", 0.5, 1.0)
    try:
        table = np.arange(6, dtype=np.float32).reshape(3, 2)
        ids = np.array([1, 7, -1, -9, 300000], dtype=np.int64)
        logp = np.log(np.full((2, 4), 0.25, dtype=np.float32))
        labels = np.array([3, 40], dtype=np.int64)
        exe = a.compile(bad, table, ids, logp, labels)
        rows, nll, grad, added = a.get_tree(exe(table, ids, logp, labels))
        torch.cuda.synchronize()
        np.testing.assert_array_equal(rows, table[[1, 2, 2, 0, 2]])
        assert nll[0] == pytest.approx(np.log(4.0)) and np.isnan(nll[1])
        np.testing.assert_array_equal(grad, [[0, 0], [1, 1], [1, 1]])
        np.testing.assert_array_equal(added, [[0, 0], [2, 3], [4, 5]])
        x = b.put(np.arange(1024, dtype=np.float32))
        twice = b.compile(lambda t: t * 2.0, x)
        np.testing.assert_array_equal(b.get(twice(x)),
                                      2.0 * np.arange(1024))
        torch.cuda.synchronize()
        assert p._sessions["bystander"].exec_count == 1
    finally:
        a.close()
        b.close()
        p.close()


def test_a_factory_ops_tensor_is_made_on_the_card_and_charged(cuda):
    from kubeshare_tpu_torch.isolation.client import ProxyClient

    p = _card_proxy(cuda)
    c = ProxyClient("127.0.0.1", p.port, "factory", 0.5, 1.0)
    try:
        x = c.put(np.ones(4, dtype=np.float32))
        # traced on the card: a factory with no device makes a host
        # tensor in the trace, which the proxy's rewrite puts on its card
        exe = c.compile(lambda t: (t * 2.0,
                                   torch.ops.aten.full.default([256], 3.0)),
                        x)
        _, filled = exe(x)
        sess = p._sessions["factory"]
        assert sess.buffers[filled.handle].device.type == "cuda"
        np.testing.assert_array_equal(c.get(filled), np.full(256, 3.0))
        acct = p.hbm_accounting()["factory"]
        assert acct["balanced"] and acct["hbm_used"] == 16 + 16 + 1024
    finally:
        c.close()
        p.close()


def test_the_native_token_core_builds_beside_the_card(cuda):
    from kubeshare_tpu_torch.isolation.tokensched import (NativeTokenCore,
                                                          TokenScheduler)

    sched = TokenScheduler(1000.0, 100.0, 10.0)
    assert isinstance(sched.core, NativeTokenCore)
    assert sched.accounting()["core"] == "native"
    sched.add_client("a", 0.5, 1.0)
    assert sched.acquire("a") == 100.0
    sched.release("a", 5.0)
    sched.close()


def test_proxy_servable_on_card_equals_the_plain_apply(cuda):
    """Each batch is one execute of the exported tinymlp on the card; its
    rows equal the plain ``tinymlp.apply`` on the card (fp32, atol 1e-5),
    and it launches none of the four kernels."""
    from kubeshare_tpu_torch.isolation.client import ProxyClient
    from kubeshare_tpu_torch.models import tinymlp
    from kubeshare_tpu_torch.serving import ProxyServable

    p = _card_proxy(cuda)
    c = ProxyClient("127.0.0.1", p.port, "serve", 0.5, 1.0,
                    tpu_class="latency")
    try:
        servable = ProxyServable(c, seed=2)
        params = common.to_device(servable.params, cuda)
        x = np.random.default_rng(5).standard_normal((8, 32)).astype(
            np.float32)
        before = (tfa.launches, dict(tfl.launches))
        y = servable.execute(x)
        want = tinymlp.apply(params, torch.from_numpy(x).to(cuda))
        np.testing.assert_allclose(y, want.cpu().numpy(), atol=1e-5, rtol=0)
        assert (tfa.launches, dict(tfl.launches)) == before
        assert p._sessions["serve"].tpu_class == "latency"
    finally:
        c.close()
        p.close()


def test_the_collector_finds_the_card_and_a_pod_binds_to_it(cuda):
    """The front of the placement path on the card: the collector
    discovers the card through the ``cuda`` backend into an in-process
    registry, the engine syncs its fleet from there, and a 0.5 pod pinned
    to the card's model binds to its chip id."""
    import math

    from kubeshare_tpu_torch import constants as C
    from kubeshare_tpu_torch.scheduler import SchedulerEngine
    from kubeshare_tpu_torch.telemetry import aggregator
    from kubeshare_tpu_torch.telemetry.collector import CapacityCollector
    from kubeshare_tpu_torch.telemetry.registry import TelemetryRegistry
    from kubeshare_tpu_torch.topology.discovery import device_chip_id

    reg = TelemetryRegistry()
    col = CapacityCollector(reg, backend="cuda", lease_ttl_s=0)
    assert col.collect_once()
    card = col.last_chips[0]
    assert card.chip_id == device_chip_id(torch.device("cuda", 0))
    assert card.memory == torch.cuda.get_device_properties(0).total_memory
    assert reg.capacity()[col.node]["healthy"] is True
    eng = SchedulerEngine()
    assert aggregator.sync_engine_from_registry(eng, reg) == [col.node]
    pod = eng.submit("ns", "p", {C.POD_TPU_REQUEST: "0.5",
                                 C.POD_TPU_LIMIT: "1.0",
                                 C.POD_TPU_MODEL: card.model})
    binding = eng.schedule(pod)
    assert binding.chip_ids == [card.chip_id]
    assert binding.port == C.POD_MANAGER_PORT_START + 1
    assert binding.memory == math.floor(0.5 * card.memory)
    assert binding.env[C.ENV_VISIBLE_CHIPS] == card.chip_id
    aggregator.publish_binding(reg, pod, binding)
    assert reg.pods(node=col.node)["ns/p"]["chip_id"] == card.chip_id


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_lse_cotangent_on_card_matches_plain(cuda, causal):
    """``flash_attention_lse`` forward and backward in bf16 at a ring
    shard's shape, with a nonzero cotangent for O AND the lse (what ring
    attention's merge gives the kernels): O, the lse, dQ, dK and dV
    against the plain versions at ``KERNEL_TOL``."""
    import math

    rng = np.random.default_rng(11)
    b, s, h, d = 8, 128, 8, 32
    randn = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape).astype(np.float32)).to(cuda)
    q, k, v = (randn(b, s, h, d).to(torch.bfloat16) for _ in range(3))
    g, g_lse = randn(b, s, h, d), randn(b, s, h)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = dict(tfl.launches)
    o, lse = tfl.flash_attention_lse(*leaves, causal=causal)
    ((o * g).sum() + (lse * g_lse).sum()).backward()
    torch.cuda.synchronize()
    assert {n: tfl.launches[n] - before[n] for n in before} == \
        {"fwd": 1, "dq": 1, "dkv": 1, "prep": 0}
    scale = 1.0 / math.sqrt(d)
    ro, rlse = tfl.flash_fwd_reference(q, k, v, causal, None, scale)
    dcap = ((g * ro).sum(-1) - g_lse).transpose(1, 2)
    args = (q, k, v, g, rlse, dcap, causal, None, scale)
    rdk, rdv = tfl.flash_dkv_reference(*args)
    for got, want in ((o, ro), (lse, rlse.transpose(1, 2)),
                      (leaves[0].grad, tfl.flash_dq_reference(*args)),
                      (leaves[1].grad, rdk), (leaves[2].grad, rdv)):
        atol, rtol = tfl.KERNEL_TOL[got.dtype]
        torch.testing.assert_close(got.detach(), want, atol=atol, rtol=rtol)


_RING_RANK = """
import json
from kubeshare_tpu_torch.models import common, transformer
from kubeshare_tpu_torch.ops import flash_attention as fl
from kubeshare_tpu_torch.parallel import runner
assert runner.distributed_init_from_env()
fl.reset_launches()
r = common.run_training(transformer.init, transformer.loss_fn,
                        transformer.batch_fn, 2,
                        mesh_hooks=transformer.MESH_HOOKS)
print("RESULT", json.dumps({"loss": r.final_loss, "backend": runner.backend(),
                            "fwd": fl.launches["fwd"]}))
"""


def test_a_two_rank_ring_flash_step_on_card_matches_one_process(cuda):
    """Two ranks on the one card (gloo: they share it) train the LM at
    full width, the sequence split over sp = 2 with ring-flash attention:
    the global loss after 2 + 2 steps matches one process's to 2e-3
    (bf16 sums in another order; chip_smoke.py's gangs read at most
    4.9e-4 after 10 + 2 steps), and rank 0 launches the forward kernel
    4 times a step (the diagonal only), rank 1 8 times (past and
    diagonal)."""
    import json

    from kubeshare_tpu_torch.utils.virtualcpu import free_port

    port = free_port()
    root = Path(__file__).resolve().parent.parent
    procs = []
    for rank in range(2):
        env = dict(os.environ, KUBESHARE_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   KUBESHARE_TPU_NUM_PROCESSES="2",
                   KUBESHARE_TPU_PROCESS_ID=str(rank),
                   KUBESHARE_TPU_RENDEZVOUS_TIMEOUT_S="120",
                   KUBESHARE_TPU_MESH="dp=1,sp=2,tp=1",
                   KUBESHARE_TPU_SP_ATTN="ring_flash",
                   PYTHONPATH=str(root))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RING_RANK], env=env, cwd=str(root),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=300) for p in procs]
    got = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        got.append(json.loads(out.split("RESULT", 1)[1]))
    one = common.run_training(transformer.init, transformer.loss_fn,
                              transformer.batch_fn, 2)
    for rank, rec in enumerate(got):
        assert rec["backend"] == "gloo"
        assert rec["loss"] == pytest.approx(one.final_loss, rel=2e-3)
        assert rec["fwd"] == transformer.LAYERS * (1 + rank) * 4


_ELASTIC_RANK = """
import json
import numpy as np
from kubeshare_tpu_torch.elastic import ElasticTrainer
from kubeshare_tpu_torch.elastic.restate import whole_leaf
from kubeshare_tpu_torch.models import transformer
from kubeshare_tpu_torch.ops import flash_attention as fl
from kubeshare_tpu_torch.ops.fused_adam import fused_adam
from kubeshare_tpu_torch.parallel import runner
from kubeshare_tpu_torch.utils.tree import tree_leaves
assert runner.distributed_init_from_env()

def whole(tree):
    wholes = [whole_leaf(x) for x in tree_leaves(tree)]
    return [None if w is None else w.cpu().numpy().tobytes() for w in wholes]

tr = ElasticTrainer(transformer.flash_loss_fn, fused_adam(1e-3),
                    transformer.init(3), devices=[0])
tr.train_step(tuple(transformer.batch_fn(4)))
before = whole((tr.params, tr.opt_state))
same, fwd = [], []
for ranks in ([0, 1], [1]):
    rec = tr.resize(ranks)
    after = whole((tr.params, tr.opt_state))
    if None not in before and None not in after:
        same.append(before == after)
    fl.reset_launches()
    tr.train_step(tuple(transformer.batch_fn(5 + len(ranks))))
    fwd.append(fl.launches["fwd"])
    before = whole((tr.params, tr.opt_state))
print("RESULT", json.dumps({"same": same, "fwd": fwd, "step": tr.step,
                            "stats": rec["stats"],
                            "backend": runner.backend()}))
"""


def test_an_elastic_resize_on_card_keeps_the_state_and_runs_flash(cuda):
    """Two ranks on the one card (gloo) hold the flash LM's
    ``ElasticTrainer``: grown from rank 0 to ranks [0, 1] and shrunk onto
    rank 1 alone, the state a rank held before each resize comes back bit
    for bit, and only the ranks in the mesh launch the flash forward,
    once a layer a step."""
    import json

    from kubeshare_tpu_torch.utils.virtualcpu import free_port

    port = free_port()
    root = Path(__file__).resolve().parent.parent
    procs = []
    for rank in range(2):
        env = dict(os.environ, KUBESHARE_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   KUBESHARE_TPU_NUM_PROCESSES="2",
                   KUBESHARE_TPU_PROCESS_ID=str(rank),
                   KUBESHARE_TPU_RENDEZVOUS_TIMEOUT_S="120",
                   PYTHONPATH=str(root))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _ELASTIC_RANK], env=env, cwd=str(root),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=300) for p in procs]
    got = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        got.append(json.loads(out.split("RESULT", 1)[1]))
    layers = transformer.LAYERS
    # rank 0 compares across the grow, rank 1 across the shrink
    assert [r["same"] for r in got] == [[True], [True]]
    assert [r["fwd"] for r in got] == [[layers, 0], [layers, layers]]
    for rec in got:
        assert rec["backend"] == "gloo" and rec["step"] == 3
        assert rec["stats"]["resharded"] == 3 * len(
            tree_leaves(transformer.init(0))) + 1


def test_the_standalone_backend_runs_its_proxy_on_the_card(cuda, tmp_path):
    """``tools/launch_backend_torch.py`` with no ``--device``: the proxy
    it brings up serves the card, a gate is granted the token through the
    client's pod manager, and SIGTERM stops the tool and every process it
    started."""
    import json
    import signal
    import socket

    import chip_smoke
    from kubeshare_tpu_torch.isolation.client import ExecutionGate
    from kubeshare_tpu_torch.nodeagent.launcherd import TOKEN_PORT_OFFSET
    from kubeshare_tpu_torch.topology.discovery import discover_chips

    chip = discover_chips("cuda")[0].chip_id
    port = chip_smoke._free_port()
    start = chip_smoke._free_port_pair()
    (tmp_path / "cfg.json").write_text(json.dumps({
        "chips": [chip], "clients": [{"name": "ns/a", "chip": chip,
                                      "request": 0.5, "limit": 1.0,
                                      "port": port}]}))
    log = tmp_path / "tool.log"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KUBESHARE_TPU_")}
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, str(REPO / "tools" / "launch_backend_torch.py"),
             "--config", str(tmp_path / "cfg.json"), "--base-dir",
             str(tmp_path), "--port-start", str(start)],
            stdout=out, stderr=subprocess.STDOUT, cwd=REPO, env=env)

    def line(match, what):
        """The first line of the log that ``match`` takes (several
        processes write the log: the tool, its proxy and its manager)."""
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            for x in log.read_text().splitlines():
                if match(x):
                    return x
            assert proc.poll() is None, log.read_text()[-3000:]
            time.sleep(0.05)
        raise AssertionError(f"no {what}: {log.read_text()[-3000:]}")

    try:
        info = line(lambda x: x.startswith('{"base_dir"'), "JSON line")
        assert json.loads(info)["exec_ports"] == {chip: start}
        line(lambda x: x == f"READY {start} TOKENS {start + TOKEN_PORT_OFFSET}",
             "proxy READY")
        line(lambda x: "chip proxy serving cuda" in x, "proxy on the card")
        line(lambda x: x == f"READY {port}", "manager READY")
        gate = ExecutionGate.connect("127.0.0.1", port, "ns/a", 0.5, 1.0)
        try:
            gate()
            assert gate.stats()["acquires"] == 1
        finally:
            gate.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    assert rc == 0, log.read_text()[-3000:]
    for p in (start, start + TOKEN_PORT_OFFSET, port):
        with socket.socket() as s:
            assert s.connect_ex(("127.0.0.1", p)) != 0, p
