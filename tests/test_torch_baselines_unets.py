"""The port's ResNet-encoder UNets (TransUNet, MUNet, GoinNet), the small
ViT encoder and SmallDecoder against the JAX package's, on the CPU, with
the helpers and the tolerance of tests/test_torch_baselines.py (REL of
max-abs, eval and train mode)."""

import numpy as np
import pytest

from test_torch_baselines import _images, check_parity

# name -> (JAX constructor keywords, port-only keywords, input). The
# ResNet-34 encoder has fixed widths: its bottom is 2x2 at 64 px and 3x3
# at 96 (GoinNet's auxiliary head pools it: its train-mode batch
# statistics over 18 values). ViTEncoder and SmallDecoder narrowed;
# SmallDecoder on 16-wide embeddings, so that its proj_in exists
NETS = {
    "transunet": (dict(num_classes=2), {}, lambda: _images(hw=64)),
    "munet": (dict(num_classes=2), {}, lambda: _images(hw=64)),
    "goinnet": (dict(num_classes=2), {}, lambda: _images(hw=96)),
    "vit": (dict(dim=32, depth=2, heads=4, patch=8), dict(image_size=32),
            lambda: _images(hw=32)),
    "smalldecoder": (dict(num_classes=3, dim=32, depth=2, heads=4),
                     dict(in_dim=16), lambda: _images(c=16, hw=4)),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(NETS))
def test_unet_and_vit_match_jax(name, train):
    jkw, tkw, make = NETS[name]
    # SmallDecoder's masks are (B, K, h, w) in both packages
    check_parity(name, jkw, tkw, [make()], train,
                 nhwc_out=name != "smalldecoder")


def test_small_decoder_without_projection():
    """Embeddings as wide as the decoder: no proj_in, in either package."""
    net = check_parity("smalldecoder", dict(num_classes=2, dim=16, depth=1,
                                            heads=2), {},
                       [_images(c=16, hw=4)], False, nhwc_out=False)
    assert not hasattr(net, "proj_in")
    assert np.isfinite(net.cls_tokens.detach().numpy()).all()
