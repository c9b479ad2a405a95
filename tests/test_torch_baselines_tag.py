"""The port's TAG part-token classifier and the implicit realism critics
(ImplicitNet, ImplicitEfficientNet with its three heads) against the JAX
package's, on the CPU, with the helpers and the tolerance of
tests/test_torch_baselines.py (REL of max-abs, eval and train mode).

TAG runs narrowed as in tests/test_extras.py (TAG_tiny's layout with 8
parts and channels 16-128), with its last-stage encoder and without (the
conv head and its batch norm). The critics take a 1-channel
segmentation, a 3-channel natural image and a label per sample, at 64 px
(ImplicitNet's quirk gives 9x9; EfficientNet's last map is 2x2, so the
feature head's gram matrix is not of a single centred pixel)."""

import numpy as np
import pytest

from test_torch_baselines import _images, check_parity

TAG_KW = dict(num_classes=4, num_chs=(16, 32, 64, 128),
              num_parts=(8, 8, 8, 8), num_heads=(1, 2, 4, 4),
              num_enc_heads=(1, 2, 4, 4), inplanes=16)


def _critic_inputs(hw=64):
    return [_images(c=1, hw=hw, seed=2),
            np.array([1.0, 0.0], np.float32), _images(hw=hw, seed=3)]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("last_encoder", [True, False],
                         ids=["last_encoder", "conv_head"])
def test_tag_matches_jax(last_encoder, train):
    check_parity("tag", dict(TAG_KW, has_last_encoder=last_encoder), {},
                 [_images(hw=64)], train)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_implicitnet_matches_jax(train):
    net = check_parity("implicitnet", {}, {}, _critic_inputs(), train)
    assert net.pre.padding == (1, 1)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("head", ["map", "img", "feature"])
def test_implicit_efficientnet_matches_jax(head, train):
    check_parity("implicitefficientnet", dict(head_type=head), {},
                 _critic_inputs(), train, nhwc_out=head != "feature")
