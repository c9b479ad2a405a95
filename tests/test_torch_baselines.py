"""The port's baseline network zoo (models/baselines.py) against the JAX
package's, on the CPU: the convolutional classifiers and UNet, the VAE
with JAX's reparametrisation draw, the Discriminator and the WGAN-GP
helpers of train/gan on it, and ``get_network``'s refusal.
tests/test_torch_baselines_unets.py and
tests/test_torch_baselines_tag.py hold the rest of the zoo with the
helpers here (three files, so that the test workers share them out).

The JAX variables are the shapes of a flax init (``jax.eval_shape``)
filled with seeded numpy values (kernels N(0, 1/fan_in), norms and batch
statistics near 1 and 0), carried across with
``models/convert.baseline_state_dict_from_flax``; every JAX apply is
jitted. Inputs are NCHW for the port and the same arrays NHWC for JAX.

Tolerance, float32: each output of the port within REL (1e-5) of the JAX
output's max-abs, in eval mode and in train mode, and the running
statistics a train-mode forward commits within REL of theirs. In train
mode the batch norms normalise by batch statistics taken as E[x^2] -
E[x]^2 (flax's fast variance), which cancels where a channel's mean is
large against its spread, so that two float32 forwards can part by more
than REL where both are as close to the exact one as float32 allows
(ImplicitNet in train mode does). So in train mode an output that misses
REL against JAX's float32 forward is held against JAX's float64 forward
of the same variables and inputs instead: within REL of max-abs of it,
or no further from it than JAX's own float32 forward is.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tee_optical_flow_torch.models import baselines as tb
from tee_optical_flow_torch.models.common import commit_batch_stats
from tee_optical_flow_torch.models.convert import (
    baseline_state_dict_from_flax,
)
from tee_optical_flow_torch.train import gan as t_gan
from tee_optical_flow_tpu.models import baselines as jb
from tee_optical_flow_tpu.train import gan as j_gan

torch.set_num_threads(1)

REL = 1e-5


def jax_variables(net, inputs, seed=0):
    """Seeded numpy variables in the shapes of ``net.init``."""
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0),
                                             *inputs))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        names = [getattr(p, "key", str(p)) for p in path]
        name, shape = names[-1], s.shape
        if names[0] == "batch_stats":
            v = (0.1 * rng.normal(size=shape) if name == "mean"
                 else rng.uniform(0.5, 1.5, size=shape))
        elif name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "bias":
            v = 0.1 * rng.normal(size=shape)
        elif name == "kernel":
            # DenseGeneral's query/key/value kernels are (D, heads, hd)
            qkv = len(shape) == 3 and names[-2] != "out"
            fan = shape[0] if qkv else int(np.prod(shape[:-1]))
            v = rng.normal(size=shape) / np.sqrt(fan)
        elif name == "mix":
            v = rng.normal(size=shape) / np.sqrt(shape[0])
        else:
            v = 0.02 * rng.normal(size=shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _nhwc(a):
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1)) if a.ndim == 4 \
        else a


def _as_tuple(o):
    return o if isinstance(o, tuple) else (o,)


def _jax_apply(net, variables, inputs, train, x64=False, **kw):
    """The JAX forward (and, in train mode, its new batch statistics),
    jitted; ``x64`` runs it in float64 on float64 copies."""
    has_stats = "batch_stats" in variables

    def apply(v, *x):
        if train and has_stats:
            return net.apply(v, *x, train=True, mutable=["batch_stats"],
                             **kw)
        return net.apply(v, *x, train=train, **kw), None

    if not x64:
        out, new = jax.jit(apply)(variables, *inputs)
        return [np.asarray(o) for o in _as_tuple(out)], new
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        x = [jnp.asarray(a, jnp.float64) for a in inputs]
        out, _ = jax.jit(apply)(v64, *x)
        return [np.asarray(o) for o in _as_tuple(out)], None


def check_parity(name, jkw, tkw, inputs, train, nhwc_out=True, seed=0,
                 apply_kw=None, port_kw=None):
    """``get_network(name, **jkw)`` of both packages (``name``
    "smalldecoder": SmallDecoder) on the same variables and ``inputs``
    (NCHW numpy; ``tkw`` the port's extra constructor fields): each
    output within REL of max-abs (see the module docstring for train
    mode), and in train mode the committed running statistics. 4-D JAX
    outputs are NHWC unless ``nhwc_out`` is False. ``apply_kw`` go to the
    JAX apply, ``port_kw`` to the port's forward."""
    apply_kw, port_kw = apply_kw or {}, port_kw or {}
    if name == "smalldecoder":
        jnet, net = jb.SmallDecoder(**jkw), tb.SmallDecoder(**jkw, **tkw)
    else:
        jnet = jb.get_network(name, **jkw)
        net = tb.get_network(name, **jkw, **tkw)
    jin = [jnp.asarray(_nhwc(a)) for a in inputs]
    variables = jax_variables(jnet, jin, seed)
    net.load_state_dict(baseline_state_dict_from_flax(name, variables,
                                                      **jkw, **tkw))
    ref, new_stats = _jax_apply(jnet, variables, jin, train, **apply_kw)
    with torch.no_grad():
        got = _as_tuple(net(*[torch.from_numpy(a) for a in inputs],
                            train=train, **port_kw))
    ref64 = None
    for k, (r, g) in enumerate(zip(ref, got)):
        if nhwc_out and r.ndim == 4:
            r = r.transpose(0, 3, 1, 2)
        assert g.shape == r.shape, (name, k, g.shape, r.shape)
        g = g.numpy()
        mag = float(np.abs(r).max())
        err = float(np.abs(g - r).max())
        if err <= REL * mag:
            continue
        assert train, (name, k, err, mag)
        if ref64 is None:
            ref64 = _jax_apply(jnet, variables, jin, train, x64=True,
                               **apply_kw)[0]
        r64 = ref64[k].transpose(0, 3, 1, 2) if nhwc_out and \
            ref64[k].ndim == 4 else ref64[k]
        own = float(np.abs(r - r64).max())
        ours = float(np.abs(g - r64).max())
        assert ours <= max(REL * mag, own), (name, k, err, ours, own, mag)
    if new_stats is not None:
        assert commit_batch_stats(net) > 0
        want = baseline_state_dict_from_flax(
            name, {"params": variables["params"],
                   "batch_stats": new_stats["batch_stats"]}, **jkw, **tkw)
        have = net.state_dict()
        for key, value in want.items():
            if "running" in key:
                assert float((have[key] - value).abs().max()) <= REL * float(
                    value.abs().max()), (name, key)
    return net


def _images(n=2, c=3, hw=32, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, c, hw, hw)).astype(np.float32)


# name -> (JAX constructor keywords, port-only keywords, input size).
# UNet, VGG and the Discriminator narrowed; ResNet, SqueezeNet and
# EfficientNet have fixed widths. ResNet's last stage at 96 px is 3x3
# (its train-mode batch statistics over 18 values), EfficientNet's at
# 64 px 2x2
CONV_NETS = {
    "unet": (dict(num_classes=3, base=8, depth=2), {}, 32),
    "resnet": (dict(num_classes=3), {}, 96),
    "seresnet": (dict(num_classes=3), {}, 96),
    "vgg": (dict(num_classes=3, cfg=(8, "M", 16, "M", 32)), {}, 32),
    "squeezenet": (dict(num_classes=3), {}, 32),
    "efficientnet": (dict(num_classes=3), {}, 64),
    "discriminator": (dict(base=8), {}, 32),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(CONV_NETS))
def test_conv_net_matches_jax(name, train):
    jkw, tkw, hw = CONV_NETS[name]
    check_parity(name, jkw, tkw, [_images(hw=hw)], train)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_vae_matches_jax_with_its_draw(train):
    """(recon, mu, logvar) with JAX's reparametrisation draw passed as
    ``eps``; without a draw z = mu in both."""
    jkw, tkw = dict(latent_dim=16, hidden=(8, 16, 32, 64)), dict(
        image_size=32)
    key = jax.random.PRNGKey(7)
    eps = np.array(jax.random.normal(key, (2, 16)))
    net = check_parity("vae", jkw, tkw, [_images()], train,
                       apply_kw=dict(rng=key),
                       port_kw=dict(eps=torch.from_numpy(eps)))
    x = torch.from_numpy(_images())
    with torch.no_grad():
        r1, mu, _ = net(x, eps=torch.from_numpy(eps))
        r0, mu0, _ = net(x)
        g = torch.Generator().manual_seed(0)
        r2, _, _ = net(x, generator=g)
    assert torch.equal(mu, mu0) and not torch.equal(r0, r1)
    assert r2.shape == r1.shape == x.shape and not torch.equal(r2, r0)


def test_gradient_penalty_on_the_discriminator_matches_jax():
    """WGAN-GP on the ported Discriminator against JAX train/gan on the
    JAX one, JAX's interpolation draw passed as ``eps``: the penalty, the
    loss and the loss's gradient in every parameter (a double backward
    through the convolutions), within REL of max-abs."""
    jnet = jb.Discriminator(base=8)
    rng = np.random.default_rng(3)
    real, fake = (rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
                  for _ in range(2))
    jreal, jfake = jnp.asarray(_nhwc(real)), jnp.asarray(_nhwc(fake))
    variables = jax_variables(jnet, [jreal])
    key = jax.random.PRNGKey(5)

    def disc_apply(params, x):
        return jnet.apply({"params": params}, x)

    @jax.jit
    def jax_loss(params):
        return j_gan.discriminator_loss(disc_apply, params, jreal, jfake,
                                        key)

    (ref_loss, (_, _, ref_gp)), ref_grads = jax.value_and_grad(
        jax_loss, has_aux=True)(variables["params"])
    eps = torch.from_numpy(np.array(jax.random.uniform(key, (2, 1, 1, 1))))
    net = tb.Discriminator(base=8)
    net.load_state_dict(baseline_state_dict_from_flax(
        "discriminator", variables, base=8))
    loss, (_, _, gp) = t_gan.discriminator_loss(
        net, torch.from_numpy(real), torch.from_numpy(fake), eps=eps)
    assert float(gp.detach()) == pytest.approx(float(ref_gp), rel=REL)
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=REL)
    loss.backward()
    want = baseline_state_dict_from_flax(
        "discriminator", {"params": jax.tree.map(np.asarray, ref_grads)},
        base=8)
    for key_, p in net.named_parameters():
        scale = float(want[key_].abs().max())
        assert float((p.grad - want[key_]).abs().max()) <= REL * scale, key_
    opt = torch.optim.SGD(net.parameters(), lr=0.1)
    before = net.head.weight.detach().clone()
    t_gan.update_d(net, opt, torch.from_numpy(real), torch.from_numpy(fake),
                   eps=eps)
    assert not torch.equal(before, net.head.weight)


def test_get_network_refuses_an_unknown_name_as_jax():
    with pytest.raises(ValueError) as j:
        jb.get_network("alexnet")
    with pytest.raises(ValueError) as t:
        tb.get_network("alexnet")
    assert str(t.value) == str(j.value)
    with pytest.raises(ValueError, match="keys differ"):
        baseline_state_dict_from_flax("unet", {"params": {}}, base=8,
                                      depth=2)
