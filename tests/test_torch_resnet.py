"""The port's ResNet-18 and ResNet-50-class depth against the JAX
package's, on the CPU: one train step with fused Adam each, in fp32 and
in the model's bf16, with the inputs, narrowing and tolerances of
``test_torch_zoo.py`` (whose helpers these are). The stride-2 stage
openers take XLA's SAME split (pad low 0, high 1) on their 3×3 conv and
a stride-2 1×1 projection on the shortcut.
"""

import numpy as np
import pytest
import torch

from kubeshare_tpu_torch.models import common
from kubeshare_tpu_torch.models import resnet as tresnet
from kubeshare_tpu_torch.ops import fused_adam as tfa
from kubeshare_tpu_torch.utils.tree import tree_leaves
from test_torch_zoo import check_bf16_step, check_fp32_step

CASES = ("resnet18", "resnet50")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("case", CASES)
def test_resnet_step_fp32_matches_jax(case):
    check_fp32_step(case)


@pytest.mark.parametrize("case", CASES)
def test_resnet_step_bf16_matches_jax(case):
    check_bf16_step(case)


def test_resnet50_class_depth():
    """(3, 4, 6, 3) blocks: 140 leaves, three fused-Adam launches a step
    on the card (76 leaves and two for ResNet-18)."""
    params = tresnet.init50(0)
    blocks = [k for k in params if k[0] == "s" and k[2] == "b"]
    assert len(blocks) == 16 and len(tree_leaves(params)) == 140
    assert tfa.tree_launches(params) == 3
    assert len(tree_leaves(tresnet.init(0))) == 76
    assert tfa.tree_launches(tresnet.init(0)) == 2
    # a stride-2 stage opener has the 1x1 projection; the others none
    assert "proj" in params["s1b0"] and "proj" not in params["s1b1"]
    assert params["s1b0"]["proj"]["w"].shape == (1, 1, 64, 128)


def test_resnet_halves_the_grid_at_each_stage(monkeypatch):
    """32 → 32 → 16 → 8 → 4 through the stem and each stage's first
    block, batch 2 at narrow width; a block's output is fp32."""
    monkeypatch.setattr(tresnet, "STAGES", (8, 16, 32, 64))
    p = common.to_device(tresnet.init(0), "cpu")
    h = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    h = tresnet.conv2d_apply(p["stem"], h, dtype=tresnet.DTYPE)
    sizes = [h.shape[1]]
    for s in range(4):
        h = tresnet._block_apply(p[f"s{s}b0"], h.float(), 2 if s else 1)
        assert h.dtype == torch.float32
        sizes.append(h.shape[1])
    assert sizes == [32, 32, 16, 8, 4]
