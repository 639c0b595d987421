"""Tests of the port that need an NVIDIA card (marker ``cuda``).

CUDA kernels have no CPU mode, so these skip on a machine without a card.
This file imports no JAX: it runs where the port runs. On the card::

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from kubeshare_tpu_torch.models import common, mnist
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
