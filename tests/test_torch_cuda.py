"""Tests of the port that need an NVIDIA card (marker ``cuda``).

CUDA kernels have no CPU mode, so these skip on a machine without a card.
This file imports no JAX: it runs where the port runs. On the card::

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from kubeshare_tpu_torch.models import common, mnist, transformer
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
    # (b, s, h, hk, d, dtype, causal, window)
    (8, 256, 8, 8, 32, torch.bfloat16, True, None),    # the main path
    (8, 256, 8, 2, 32, torch.bfloat16, True, None),    # GQA
    (8, 256, 8, 8, 32, torch.bfloat16, True, 100),     # window
    (8, 256, 8, 8, 32, torch.bfloat16, False, None),
    (8, 256, 8, 8, 32, torch.float32, True, None),
    (2, 48, 4, 1, 8, torch.float32, True, 7),          # ragged tiles, MQA
    (1, 80, 2, 2, 8, torch.bfloat16, False, None),
    (2, 128, 4, 2, 8, torch.bfloat16, True, None),     # the small preset
    (2, 48, 4, 1, 8, torch.bfloat16, True, 7),         # ragged, bf16
    (2, 48, 4, 2, 32, torch.bfloat16, True, None),
    (1, 80, 2, 2, 32, torch.bfloat16, False, None),
    (1, 200, 4, 4, 32, torch.bfloat16, True, 70),      # ragged, window
]


@pytest.mark.parametrize("b,s,h,hk,d,dtype,causal,window", FLASH_SHAPES)
def test_flash_kernels_match_plain_on_card(cuda, b, s, h, hk, d, dtype,
                                           causal, window):
    q, k, v = _qkv(cuda, b, s, h, hk, d, dtype)
    dout = torch.randn(b, s, h, d, device=cuda)
    scale = 1.0 / np.sqrt(d)
    before = dict(tfl.launches)
    o, lse = tfl.flash_fwd(q, k, v, causal, window, scale)
    ro, rlse = tfl.flash_fwd_reference(q, k, v, causal, window, scale)
    _assert_kernel_close(o, ro)
    _assert_kernel_close(lse, rlse)
    dcap = (dout * ro).sum(-1).transpose(1, 2)
    dq = tfl.flash_dq(q, k, v, dout, rlse, dcap, causal, window, scale)
    dk, dv = tfl.flash_dkv(q, k, v, dout, rlse, dcap, causal, window, scale)
    rdq = tfl.flash_dq_reference(q, k, v, dout, rlse, dcap, causal, window,
                                 scale)
    rdk, rdv = tfl.flash_dkv_reference(q, k, v, dout, rlse, dcap, causal,
                                       window, scale)
    torch.cuda.synchronize()
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        _assert_kernel_close(got, want)
    assert {n: tfl.launches[n] - before[n] for n in before} == \
        {"fwd": 1, "dq": 1, "dkv": 1}


@pytest.mark.parametrize("pad", [0, 1], ids=["aligned", "unaligned"])
def test_flash_fwd_on_strided_views_on_card(cuda, pad):
    """The bf16 forward on q/k/v views of one fused tensor: rows 16-byte
    aligned (cp.async copies) and not (the same kernel's plain loads)."""
    q, k, v = _fused_qkv(cuda, 2, 256, 8, 2, 32, torch.bfloat16, pad)
    assert not q.is_contiguous()
    o, lse = tfl.flash_fwd(q, k, v, True, None, 32 ** -0.5)
    ro, rlse = tfl.flash_fwd_reference(q, k, v, True, None, 32 ** -0.5)
    _assert_kernel_close(o, ro)
    _assert_kernel_close(lse, rlse)


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
        {"fwd": 1, "dq": 1, "dkv": 1}
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
    for d in (16, 64, 128):
        q, k, v = _qkv(cuda, 1, 32, 2, 2, d, torch.float32)
        with pytest.raises(ValueError, match="head dims"):
            tfl.flash_attention(q, k, v)
    q, k, v = _qkv(cuda, 1, 32, 2, 2, 32, torch.float16)
    with pytest.raises(TypeError):
        tfl.flash_attention(q, k, v)
