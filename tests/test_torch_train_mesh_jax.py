"""The port's SAM fine-tuning on a mesh of CPU ranks against the JAX
package's train step on a CPU device mesh, and the port's
parallel/shardings.sam_param_shardings against the JAX package's rule.

The model is the mini vit_t-shaped arch of tests/conftest.py (image 64,
embed dims (16, 32, 40, 80), 3 classes, no adapters) with seeded random
JAX variables (``jax.eval_shape`` of the init, numpy values), carried
across by ``convert.sam_state_dict_from_flax``; global batch 4, AdamW lr
1e-3 with warmup 2 and layer decay 0.8, as test_three_steps_match_jax in
tests/test_torch_train.py. The port runs 2 ranks (2x1) and 4 ranks (2x2
with sam_param_shardings) through parallel/launch.py; the JAX package
runs its jitted step once, on a 2x2 mesh with
``param_sharding_fn=sam_param_shardings``, whose data axis of 2 splits
the batch as the port's 2 ranks do (one compile serves both
comparisons). The JAX gradients are its train step's own, read through
an optax transform that keeps them as its state.

Tolerances: each of 3 steps' loss within 1e-4 relative (as
test_three_steps_match_jax); one step's gradients within 1e-4 of each
tensor's max-abs, tensors that are zero in exact arithmetic under 1e-7 of
the largest gradient, as in tests/test_torch_train.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tee_optical_flow_torch import config as t_config
from tee_optical_flow_torch.models import registry as t_registry
from tee_optical_flow_torch.models.convert import (
    sam_flax_paths, sam_state_dict_from_flax,
)
from tee_optical_flow_torch.parallel import shardings as t_shardings
from tee_optical_flow_torch.parallel.launch import launch
from tee_optical_flow_torch.parallel.mesh import (
    ProcessMesh, make_mesh as t_make_mesh,
)
from tee_optical_flow_torch.train import loop as t_loop
from tee_optical_flow_torch.train.mesh_steps import run_steps
from tee_optical_flow_tpu import config as j_config
from tee_optical_flow_tpu.models.sam import Sam as JSam
from tee_optical_flow_tpu.models.tinyvit import TinyViT as JTinyViT
from tee_optical_flow_tpu.parallel import shardings as j_shardings
from tee_optical_flow_tpu.parallel.mesh import make_mesh
from tee_optical_flow_tpu.train import loop as j_loop

torch.set_num_threads(1)

MINI = dict(embed_dims=(16, 32, 40, 80), depths=(1, 1, 2, 1),
            num_heads=(1, 2, 2, 2), window_sizes=(4, 4, 4, 4), neck_dim=64)
SIZE, OUT, CLASSES, BATCH = 64, 16, 3, 4
LOSS_REL = 1e-4
GRAD_REL = 1e-4
GRAD_NOISE = 1e-7
CFG = dict(num_cls=CLASSES, image_size=SIZE, out_size=OUT, lr=1e-3,
           warmup_period=2, epochs=1, layer_lr_decay=0.8)
MODEL = {"arch": "tinyvit", "tinyvit": dict(img_size=SIZE, **MINI),
         "sam": dict(num_classes=CLASSES, image_size=SIZE, embed_dim=64)}


def _random_variables(model, size, seed):
    """Seeded values of the JAX ``model``'s tree (shapes from
    ``jax.eval_shape`` of its init): kernels normal with variance
    1/fan_in, norm scales 1 + 0.1 N, biases, batch means and attention
    biases 0.1 N, batch variances 1 + 0.1 |N|, the rest N(0, 1)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        z = rng.normal(size=shape).astype(np.float32)
        if name == "kernel":
            return z / np.float32(np.sqrt(np.prod(shape[:-1])))
        if name == "var":
            return 1 + 0.1 * np.abs(z)
        if name in ("scale", "weight"):
            return 1 + 0.1 * z
        if name in ("bias", "mean", "attention_biases"):
            return 0.1 * z
        return z

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def mini():
    model = JSam(image_encoder=JTinyViT(img_size=SIZE, **MINI),
                 num_classes=CLASSES, image_size=SIZE, embed_dim=64)
    variables = jax.tree.map(np.asarray, _random_variables(model, SIZE, 1))
    return model, variables


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(6)
    yy, xx = np.mgrid[0:OUT, 0:OUT]
    out = []
    for k in range(3):
        images = rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)
        labels = np.stack([
            np.where(yy > 12 - j, 2,
                     (yy - 5 - j - k) ** 2 + (xx - 8 + j) ** 2 < 14 + 3 * j)
            for j in range(BATCH)]).astype(np.int32)
        out.append((images, labels))
    return out


def _keeping(tx):
    """``tx``, keeping the last raw gradients beside its state: the JAX
    train step's gradients, as it computed them."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _jax_run(mini, batches, mesh, shard):
    """(the 3 steps' losses, the first step's gradients under the port's
    names) of the JAX package's train step on ``mesh`` (one compile)."""
    jmodel, variables = mini
    cfg = j_config.TrainConfig(**CFG)
    rt = j_loop.build_runtime(cfg, steps_per_epoch=3, mesh=mesh)
    rt = dataclasses.replace(rt, tx=_keeping(rt.tx))
    init, step = j_loop.make_train_step(
        jmodel, rt,
        param_sharding_fn=j_shardings.sam_param_shardings if shard else None)
    trainable, frozen, stats, opt_state = init(variables)
    losses, grads = [], None
    for images, labels in batches:
        trainable, stats, opt_state, metrics = step(
            trainable, frozen, stats, opt_state, jnp.asarray(images),
            jnp.asarray(labels))
        losses.append(float(metrics["total_loss"]))
        if grads is None:
            grads = jax.tree.map(np.asarray, opt_state[1])
    zeros = jax.tree.map(np.zeros_like, variables["params"])
    full = j_loop.merge_params(grads, zeros)
    return losses, sam_state_dict_from_flax(
        {"params": full, "batch_stats": variables["batch_stats"]}, CLASSES)


def _grouped_conv_weights(model):
    return {f"{n}.weight" for n, m in model.named_modules()
            if isinstance(m, torch.nn.Conv2d) and m.groups > 1}


@pytest.fixture(scope="module")
def port_ranks(mini, batches, tmp_path_factory):
    """{(data, model): rank 0's results} of the port's 2x1 and 2x2 (split)
    runs."""
    _, variables = mini
    root = tmp_path_factory.mktemp("mesh_jax")
    torch.save({"model": sam_state_dict_from_flax(variables, CLASSES),
                "lora": None}, root / "weights.pt")
    torch.save({"train": [(x, y, None) for x, y in batches],
                "eval": batches[0]}, root / "batches.pt")
    out = {}
    for mesh, shard in (((2, 1), False), ((2, 2), True)):
        world = mesh[0] * mesh[1]
        spec = dict(model=MODEL, weights=str(root / "weights.pt"),
                    batches=str(root / "batches.pt"), cfg=CFG,
                    policy={"finetune_type": "vanilla"}, mesh=mesh,
                    devices=["cpu"] * world, shard=shard, steps=3)
        out[mesh] = launch(run_steps, ([spec],), devices=["cpu"] * world,
                           threads=1, timeout=600)[0][0]
    return out


@pytest.fixture(scope="module")
def jax_2x2(mini, batches):
    """(losses, gradients) of the JAX package's step on its 2x2 mesh with
    sam_param_shardings."""
    mesh = make_mesh(data_axis=2, model_axis=2, devices=jax.devices()[:4])
    return _jax_run(mini, batches, mesh, True)


@pytest.mark.parametrize("key,axes,shard", [("2x1", (2, 1), False),
                                            ("2x2", (2, 2), True)])
def test_mesh_steps_match_jax(jax_2x2, port_ranks, key, axes, shard):
    """The port's ranks on the ``axes`` mesh (weights split when
    ``shard``) against the JAX package's 2x2 mesh step. That step doubles
    the gradient of every grouped (depthwise) convolution's kernel: XLA's
    partitioning sums it over the 'model' replicas too (its 1x4, 4x1 and
    2x1 meshes and its one device agree; measured ratio 2.000 on the
    mini's stage-0 kernel). So the port's gradient must be half of the
    JAX step's there, which is the one-device value that
    tests/test_torch_train_mesh.py holds the port's steps to. AdamW's
    update does not see the gradient's scale, so the losses still
    agree."""
    losses, want = jax_2x2
    got = port_ranks[axes]
    assert bool(got["split"]) == shard, key
    assert got["cross_replica"] == got["batchnorms"] > 0  # data axis 2
    for a, b in zip(got["losses"], losses):
        assert a == pytest.approx(b, rel=LOSS_REL), (got["losses"], losses)
    grouped = _grouped_conv_weights(t_registry.Sam(
        t_registry.TinyViT(img_size=SIZE, **MINI), num_classes=CLASSES,
        image_size=SIZE, embed_dim=64))
    assert len(grouped) == 1 + 4 + 3  # stage 0's MBConv, 4 local convs,
    #                                   3 merges
    names = [n for n in got["grads"]
             if not n.startswith(("image_encoder.norm_head.",
                                  "image_encoder.head."))]
    gmax = max(float(want[n].abs().max()) for n in names)
    for name in names:
        ref, g = want[name], got["grads"][name]
        if name in grouped:
            ref = 0.5 * ref
        scale = float(ref.abs().max())
        if scale < GRAD_NOISE * gmax:
            assert float(g.abs().max()) < GRAD_NOISE * gmax, name
        else:
            err = float((g - ref).abs().max())
            assert err <= GRAD_REL * scale, (name, err, scale)


def test_short_batch_raises_as_jax():
    """A batch the data axis does not divide: the JAX package's eval
    step's device_put raises ValueError (drop_last=False's short last val
    batch), and so does the port's split of the batch."""
    jmesh = make_mesh(data_axis=2, devices=jax.devices()[:2])
    cfg = j_config.TrainConfig(**CFG)
    model = JSam(image_encoder=JTinyViT(img_size=SIZE, **MINI),
                 num_classes=CLASSES, image_size=SIZE, embed_dim=64)
    rt = j_loop.TrainConfigRuntime(cfg=cfg, mesh=jmesh, schedule=None,
                                   tx=None)
    eval_step = j_loop.make_eval_step(model, rt, CLASSES)
    with pytest.raises(ValueError, match="divisible"):
        eval_step({}, {}, {}, np.zeros((3, SIZE, SIZE, 3), np.float32),
                  np.zeros((3, OUT, OUT), np.int32))
    tmesh = t_make_mesh(2, 1, ["cpu"] * 2)
    procs = ProcessMesh(mesh=tmesh, rank=0, data=0, model=0,
                        device=torch.device("cpu"), data_group=object(),
                        model_group=None)
    rt = t_loop.TrainConfigRuntime(cfg=t_config.TrainConfig(**CFG),
                                   device=torch.device("cpu"),
                                   schedule=None, mesh=tmesh, procs=procs)
    with pytest.raises(ValueError, match="divide"):
        rt.local_rows(np.zeros((3, 2)), np.zeros((3,)))
    (x, y), share = rt.local_rows(np.arange(8).reshape(4, 2), np.arange(4))
    assert share == 0.5 and x.tolist() == [[0, 1], [2, 3]]


def _jax_split(variables, nmodel):
    """{flax path: spec tuple} of the JAX rule's split kernels."""
    from flax import traverse_util

    mesh = make_mesh(data_axis=1, model_axis=nmodel,
                     devices=jax.devices()[:nmodel])
    flat = traverse_util.flatten_dict(
        j_shardings.sam_param_shardings(mesh, variables["params"]))
    return {("params",) + k: tuple(v.spec) for k, v in flat.items()
            if tuple(v.spec)}


@pytest.mark.parametrize("arch", ["mini", "vit_t"])
@pytest.mark.parametrize("nmodel", [2, 4])
def test_sharding_rule_matches_jax(mini, arch, nmodel):
    """The same leaves split over the same axes, through the converter's
    key map: flax (in, out) P(None, 'model') is the torch weight's dim 0,
    P('model', None) its dim 1. vit_t at its production widths (1024)."""
    if arch == "mini":
        jmodel, variables = mini
        port = t_registry.Sam(t_registry.TinyViT(img_size=SIZE, **MINI),
                              num_classes=CLASSES, image_size=SIZE,
                              embed_dim=64)
    else:
        jmodel = JSam(image_encoder=JTinyViT(img_size=1024),
                      num_classes=CLASSES, image_size=1024)
        variables = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                   jnp.zeros((1, 1024, 1024, 3)))
        port = t_registry.build_sam_vit_t(CLASSES, 1024, device="cpu")
    want = _jax_split(variables, nmodel)
    paths = sam_flax_paths(port)
    mesh = t_make_mesh(1, nmodel, ["cpu"] * nmodel)
    got = {paths[n]: sh.spec[::-1]
           for n, sh in t_shardings.sam_param_shardings(mesh, port).items()
           if sh.spec}
    assert got == want
    assert want
    if arch == "vit_t":
        mlp = [p for p in want if p[-2] in ("lin1", "lin2")
               and p[2].startswith("stage")]
        assert len(mlp) == 2 * 10  # fc1/fc2 of the 10 TinyViT blocks
