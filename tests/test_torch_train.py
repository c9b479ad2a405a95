"""The PyTorch port's SAM fine-tuning (train/, models/lora.py, the adapters,
the train-mode batch norm, TrainConfig, cli/train.py and cli/val.py)
against the JAX package's, on the CPU, in one process.

The model is the mini vit_t-shaped arch of tests/conftest.py (image 64,
embed dims (16, 32, 40, 80), 3 classes) with adapters in TinyViT stages
1-3 and in the decoder, batch 2, float32. Its JAX variables are seeded
random values of the flax tree (``jax.eval_shape`` of the init, no flax
init run), carried across by ``convert.sam_state_dict_from_flax``; the
LoRA factors by ``lora.lora_from_flax``. The JAX gradients are the JAX
package's own train step's, read through an optax transform that returns
them as its state.

Tolerances (from CPU runs of these tests):
  * losses and metrics: 1e-6 (measured equal or within 1 ulp);
  * schedule: 1e-6 relative at every step; layer-decay scales equal;
  * a train-mode forward: logits within 1e-5, the new running statistics
    within 1e-5 of each tensor's max-abs (measured 4.7e-7);
  * one step: the loss within 1e-5 relative (measured equal); every
    gradient within 1e-4 x its tensor's max-abs. Tensors whose gradient
    is zero in exact arithmetic (the attention k-projection biases, which
    the softmax's shift invariance cancels; the biases just before a
    train-mode batch norm, which its mean removes) hold float32 noise of
    ~1e-9 in both frameworks: there both must stay under GRAD_NOISE x
    the largest gradient of the model (measured ~1e-9 against 1.4);
  * the optimizer on identical gradients: parameters within 1e-6 after 4
    updates; three whole steps: losses within 1e-4 relative;
  * remat: loss, gradients and statistics equal to the step without it;
  * eval, data and prompts: equal (the data bit-equal).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tee_optical_flow_torch import config as t_config
from tee_optical_flow_torch.cli import process as t_process
from tee_optical_flow_torch.cli import train as t_cli_train
from tee_optical_flow_torch.cli import val as t_cli_val
from tee_optical_flow_torch.models import lora as t_lora
from tee_optical_flow_torch.models import registry as t_registry
from tee_optical_flow_torch.models.convert import sam_state_dict_from_flax
from tee_optical_flow_torch.models.sam import Sam, make_clip_segmentor
from tee_optical_flow_torch.models.tinyvit import TinyViT
from tee_optical_flow_torch.train import checkpoint as t_checkpoint
from tee_optical_flow_torch.train import data as t_data
from tee_optical_flow_torch.train import eval as t_eval
from tee_optical_flow_torch.train import gan as t_gan
from tee_optical_flow_torch.train import loop as t_loop
from tee_optical_flow_torch.train import losses as t_losses
from tee_optical_flow_torch.train import prompts as t_prompts
from tee_optical_flow_torch.train import schedule as t_schedule
from tee_optical_flow_tpu import config as j_config
from tee_optical_flow_tpu.models import lora as j_lora
from tee_optical_flow_tpu.models.sam import Sam as JSam
from tee_optical_flow_tpu.models.tinyvit import TinyViT as JTinyViT
from tee_optical_flow_tpu.parallel.mesh import make_mesh
from tee_optical_flow_tpu.train import data as j_data
from tee_optical_flow_tpu.train import eval as j_eval
from tee_optical_flow_tpu.train import gan as j_gan
from tee_optical_flow_tpu.train import loop as j_loop
from tee_optical_flow_tpu.train import losses as j_losses
from tee_optical_flow_tpu.train import prompts as j_prompts
from tee_optical_flow_tpu.train import schedule as j_schedule

from conftest import MINI_HEADS_BY_DIM

torch.set_num_threads(1)

MINI = dict(embed_dims=(16, 32, 40, 80), depths=(1, 1, 2, 1),
            num_heads=(1, 2, 2, 2), window_sizes=(4, 4, 4, 4), neck_dim=64)
ADAPTERS = (1, 2, 3)
SIZE, OUT, CLASSES = 64, 16, 3
LOSS_ATOL = 1e-6
GRAD_REL = 1e-4
GRAD_NOISE = 1e-7
STATS_REL = 1e-5
POLICIES = {
    "vanilla": dict(finetune_type="vanilla", if_update_encoder=True),
    "frozen_encoder": dict(finetune_type="vanilla", if_update_encoder=False),
    "adapter": dict(finetune_type="adapter", if_update_encoder=True),
    "lora": dict(finetune_type="lora", if_update_encoder=True),
}


# --- fixtures -----------------------------------------------------------------

def _random_variables(model, size, seed):
    """Seeded random variables of the JAX ``model``'s tree (shapes from
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


def _port_mini(variables):
    model = Sam(TinyViT(img_size=SIZE, adapter_stages=ADAPTERS, **MINI),
                CLASSES, SIZE, embed_dim=64, use_decoder_adapter=True)
    model.load_state_dict(sam_state_dict_from_flax(variables, CLASSES),
                          strict=True)
    return model


@pytest.fixture(scope="module")
def mini():
    model = JSam(image_encoder=JTinyViT(img_size=SIZE,
                                        adapter_stages=ADAPTERS, **MINI),
                 num_classes=CLASSES, image_size=SIZE, embed_dim=64,
                 use_decoder_adapter=True)
    variables = jax.tree.map(np.asarray, _random_variables(model, SIZE, 1))
    return model, variables


@pytest.fixture(scope="module")
def batch():
    """Two normalised 64x64 images and 16x16 labels of two blobs each."""
    rng = np.random.default_rng(5)
    images = rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:OUT, 0:OUT]
    labels = np.stack([
        ((yy - 8) ** 2 + (xx - 7) ** 2 < 20).astype(np.int32) + (xx > 12),
        2 * ((yy - 5) ** 2 + (xx - 9) ** 2 < 16).astype(np.int32)])
    return images, labels.astype(np.int32)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(data_axis=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def jax_lora(mini):
    """The JAX package's LoRA factors on the mini model, B made non-zero
    (seeded 0.05 N) so that both factors of every site get gradients."""
    _, variables = mini
    lora = j_lora.init_lora(variables["params"], rank=4, seed=0)
    rng = np.random.default_rng(9)
    return {site: {k: (np.asarray(v) if k.startswith("a")
                       else 0.05 * rng.normal(size=v.shape).astype(
                           np.float32))
                   for k, v in fac.items()}
            for site, fac in lora.items()}


def _capture_tx():
    """An optax transform that applies nothing and keeps the gradients
    as its state: the JAX train step's gradients, as it computed them."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _jax_cfg(**kw):
    base = dict(num_cls=CLASSES, image_size=SIZE, out_size=OUT)
    base.update(kw)
    return j_config.TrainConfig(**base), t_config.TrainConfig(**base)


def _as_port_grads(jgrads, variables, policy):
    """The JAX gradient tree under the port's names and layouts."""
    if policy == "lora":
        return {f"lora/{site}/{k}": t for site, fac in
                t_lora.lora_from_flax(jgrads).items()
                for k, t in fac.items()}
    zeros = jax.tree.map(np.zeros_like, variables["params"])
    full = j_loop.merge_params(jax.tree.map(np.asarray, jgrads), zeros)
    return sam_state_dict_from_flax({"params": full,
                                     "batch_stats": variables["batch_stats"]},
                                    CLASSES)


# --- losses, metrics, schedule, layer decay ------------------------------------

def _loss_case(name, logits, labels):
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    jy, ty = jnp.asarray(labels), torch.from_numpy(labels)
    if name in ("dice_coeff_multi_class", "per_class_iou_dice"):
        pred = np.argmax(logits, axis=1).astype(np.int32)
        ref = getattr(j_losses, name)(jnp.asarray(pred), jy, CLASSES)
        got = getattr(t_losses, name)(torch.from_numpy(pred), ty, CLASSES)
    else:
        ref = getattr(j_losses, name)(jl, jy)
        got = getattr(t_losses, name)(tl, ty)
    return ref, got


@pytest.mark.parametrize("name", [
    "dice_loss", "cross_entropy_loss", "combined_loss",
    "dice_coeff_multi_class", "per_class_iou_dice", "generalized_dice_loss",
    "bce_dice_loss", "weighted_cross_entropy_loss"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(3)
    logits = (2 * rng.normal(size=(2, CLASSES, OUT, OUT))).astype(np.float32)
    labels = rng.integers(0, CLASSES, (2, OUT, OUT)).astype(np.int32)
    ref, got = _loss_case(name, logits, labels)
    ref = [ref] if not isinstance(ref, tuple) else ref
    got = [got] if not isinstance(got, tuple) else got
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=LOSS_ATOL)


@pytest.mark.parametrize("warmup,max_iters,power", [
    (10, 50, 0.9), (0, 30, 0.9), (7, 20, 1.5)])
def test_schedule_matches_jax(warmup, max_iters, power):
    ref = j_schedule.warmup_poly_schedule(1e-4, warmup, max_iters, power)
    got = t_schedule.warmup_poly_schedule(1e-4, warmup, max_iters, power)
    steps = np.arange(warmup + max_iters + 3)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(steps)), np.float64)
    have = np.asarray([got(int(s)) for s in steps])
    np.testing.assert_allclose(have, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ["vit_t", "mini"])
def test_layer_decay_scale_matches_jax(mini, arch):
    """The scale of every parameter: the JAX function on its flax path
    (filled into the tree, carried across) against the port's on the
    port's name. The classifier head the JAX tree lacks is left out;
    LoRA factors get 1.0 in both."""
    if arch == "mini":
        jmodel, port = mini[0], _port_mini(mini[1])
    else:
        jmodel = JSam(image_encoder=JTinyViT(img_size=SIZE), num_classes=3,
                      image_size=SIZE)
        port = t_registry.build_sam_vit_t(3, SIZE, device="cpu")
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(leaf.shape, j_schedule.
                                   tinyvit_lr_scale_for_path(path, 0.8),
                                   np.float32), shapes["params"])
    stats = jax.tree.map(lambda leaf: np.ones(leaf.shape, np.float32),
                         shapes["batch_stats"])
    carried = sam_state_dict_from_flax({"params": params,
                                        "batch_stats": stats}, 3)
    checked = 0
    for name, _ in port.named_parameters():
        if name.startswith(("image_encoder.norm_head.",
                            "image_encoder.head.")):
            continue
        want = float(carried[name].flatten()[0])
        assert t_schedule.tinyvit_lr_scale_for_name(name, 0.8) == \
            pytest.approx(want, rel=1e-6), name
        checked += 1
    assert checked > 100
    assert {float(v.flatten()[0]) for v in carried.values()} > {1.0}
    site = "image_encoder/stage1_block0/attn/qkv"
    assert j_schedule.tinyvit_lr_scale_for_path((site, "a_q"), 0.8) == 1.0
    assert t_schedule.tinyvit_lr_scale_for_name(
        f"lora/{t_lora.site_from_flax(site)}/a_q", 0.8) == 1.0


# --- models: train mode, LoRA --------------------------------------------------

def test_batchnorm_train_forward_matches_flax(mini, batch):
    """One train-mode forward: logits, and the running statistics flax
    writes into batch_stats."""
    jmodel, variables = mini
    images, _ = batch
    (logits, _), mutated = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables,
                                                    jnp.asarray(images))
    port = _port_mini(variables)
    x = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        got, _ = port(x, train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), rtol=0,
                               atol=1e-5)
    from tee_optical_flow_torch.models.common import commit_batch_stats

    # 2 patch-embed + 3 MBConv + 9 merge + 4 local convs
    assert commit_batch_stats(port) == 18
    ref = sam_state_dict_from_flax(
        {"params": variables["params"],
         "batch_stats": jax.tree.map(np.asarray, mutated["batch_stats"])},
        CLASSES)
    before = sam_state_dict_from_flax(variables, CLASSES)
    sd = port.state_dict()
    for key in ref:
        if "running_" in key:
            assert not torch.equal(ref[key], before[key]), key
            err = float((sd[key] - ref[key]).abs().max())
            assert err <= STATS_REL * float(ref[key].abs().max()), key


def test_lora_sites_and_merge_match_jax(mini, jax_lora):
    _, variables = mini
    port = _port_mini(variables)
    assert [t_lora.qkv_qv_columns(d, h)[i].tolist()
            for d, h in ((32, 2), (160, 5)) for i in (0, 1)] == \
        [j_lora.qkv_qv_columns(d, h)[i].tolist()
         for d, h in ((32, 2), (160, 5)) for i in (0, 1)]
    for kw in (dict(), dict(encoder_layers=[1]), dict(decoder=False),
               dict(encoder=False)):
        jsites = j_lora.init_lora(variables["params"], rank=4, **kw)
        tsites = t_lora.init_lora(port, rank=4, **kw)
        assert sorted(t_lora.site_from_flax(s) for s in jsites) == \
            sorted(tsites), kw
        for site, fac in jsites.items():
            for k, v in fac.items():
                assert tuple(tsites[t_lora.site_from_flax(site)][k].shape) \
                    == tuple(np.asarray(v).shape[::-1]), (site, k)
    merged_j = j_lora.merge_lora(jax.tree.map(jnp.asarray,
                                              variables["params"]),
                                 jax.tree.map(jnp.asarray, jax_lora),
                                 heads_by_dim=MINI_HEADS_BY_DIM)
    want = sam_state_dict_from_flax({"params": jax.tree.map(
        np.asarray, merged_j), "batch_stats": variables["batch_stats"]},
        CLASSES)
    got = t_lora.merge_lora(dict(port.named_parameters()),
                            t_lora.lora_from_flax(jax_lora),
                            MINI_HEADS_BY_DIM)
    assert len(got) == len(jax_lora)
    for key, w in got.items():
        np.testing.assert_allclose(w.detach().numpy(), want[key].numpy(),
                                   rtol=0, atol=1e-6)


# --- one step's gradients ------------------------------------------------------

@pytest.fixture(scope="module")
def jax_grads(mini, batch, mesh, jax_lora):
    """Per policy: (loss, gradients, new batch stats) of the JAX
    package's train step."""
    jmodel, variables = mini
    images, labels = batch
    out = {}
    for policy, kw in POLICIES.items():
        jcfg, _ = _jax_cfg(**kw)
        rt = j_loop.TrainConfigRuntime(cfg=jcfg, mesh=mesh,
                                       schedule=lambda s: 1e-4,
                                       tx=_capture_tx())
        lora = policy == "lora"
        init, step = j_loop.make_train_step(
            jmodel, rt, lora_merge=(
                (lambda p, f: j_lora.merge_lora(
                    p, f, heads_by_dim=MINI_HEADS_BY_DIM)) if lora else None),
            **kw)
        state = init(variables, jax_lora if lora else None)
        _, stats, grads, metrics = step(*state, jnp.asarray(images),
                                        jnp.asarray(labels))
        out[policy] = (float(metrics["total_loss"]),
                       jax.tree.map(np.asarray, grads),
                       jax.tree.map(np.asarray, stats))
    return out


def _port_step(variables, policy, jax_lora, remat=False):
    kw = POLICIES[policy]
    _, tcfg = _jax_cfg(**kw)
    port = _port_mini(variables)
    rt = t_loop.build_runtime(tcfg, 1, device="cpu")
    init, step = t_loop.make_train_step(port, rt, remat=remat,
                                        heads_by_dim=MINI_HEADS_BY_DIM, **kw)
    state = init(t_lora.lora_from_flax(jax_lora) if policy == "lora"
                 else None)
    return port, state, step


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_train_step_gradients_match_jax(mini, batch, jax_grads, jax_lora,
                                        policy):
    _, variables = mini
    loss, jgrads, _ = jax_grads[policy]
    port, state, step = _port_step(variables, policy, jax_lora)
    metrics, grads = step.loss_and_grads(state, *batch)
    assert float(metrics["total_loss"]) == pytest.approx(loss, rel=1e-5)
    want = _as_port_grads(jgrads, variables, policy)
    names = [n for n, _ in state.trainable
             if not n.startswith(("image_encoder.norm_head.",
                                  "image_encoder.head."))]
    if policy == "frozen_encoder":
        assert not any(n.startswith("image_encoder.") for n in names)
    if policy == "adapter":
        assert names and all("Adapter" in n for n in names)
    if policy == "lora":
        # 4 fused qkv sites (a_q, b_q, a_v, b_v), 14 dense (a, b)
        assert len(names) == 4 * 4 + 2 * 14
        assert not any(p.requires_grad for p in port.parameters())
    gmax = max(float(want[n].abs().max()) for n in names)
    for name in names:
        ref = want[name]
        got = grads.get(name, torch.zeros_like(ref))
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        if scale < GRAD_NOISE * gmax:
            assert float(got.abs().max()) < GRAD_NOISE * gmax, name
        else:
            assert err <= GRAD_REL * scale, (name, err, scale)


def test_remat_gives_the_same_step(mini, batch, jax_lora):
    """torch.utils.checkpoint's recompute: the same loss, gradients and
    running statistics, which move once."""
    _, variables = mini
    runs = []
    for remat in (False, True):
        port, state, step = _port_step(variables, "vanilla", jax_lora,
                                       remat=remat)
        metrics, grads = step.loss_and_grads(state, *batch)
        stats = {k: v.clone() for k, v in port.state_dict().items()
                 if "running_" in k}
        runs.append((metrics, grads, stats))
    (m0, g0, s0), (m1, g1, s1) = runs
    assert float(m0["total_loss"]) == float(m1["total_loss"])
    assert sorted(g0) == sorted(g1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    before = sam_state_dict_from_flax(variables, CLASSES)
    for key in s0:
        assert torch.equal(s0[key], s1[key]), key
        assert not torch.equal(s0[key], before[key]), key


def test_box_prompted_step(mini, batch, jax_lora):
    """Box prompts reach the prompt encoder: the box-corner embeddings
    get gradients only when boxes are given, and the loss changes."""
    _, variables = mini
    boxes = np.asarray([[8, 10, 40, 50], [20, 4, 60, 30]], np.float32)
    out = []
    for b in (None, boxes):
        _, state, step = _port_step(variables, "vanilla", jax_lora)
        metrics, grads = step.loss_and_grads(state, *batch, boxes=b)
        out.append((float(metrics["total_loss"]), grads))
    corner = "prompt_encoder.point_embeddings.2.weight"
    assert corner not in out[0][1] or not out[0][1][corner].any()
    assert out[1][1][corner].abs().max() > 0
    assert np.isfinite(out[1][0]) and out[1][0] != out[0][0]


# --- the optimizer, whole steps ------------------------------------------------

def test_optimizer_matches_optax_on_identical_gradients(mini):
    """optax adamw + layer decay + MultiSteps(2), 8 micro-steps (4
    updates) of the same seeded gradients, against TrainOptimizer."""
    _, variables = mini
    jcfg, tcfg = _jax_cfg(lr=1e-3, weight_decay=0.1, warmup_period=3,
                          epochs=2, layer_lr_decay=0.8, grad_accum=2)
    rt = j_loop.build_runtime(jcfg, steps_per_epoch=4,
                              mesh=make_mesh(data_axis=1,
                                             devices=jax.devices()[:1]))
    params = variables["params"]
    opt_state = rt.tx.init(params)
    update = jax.jit(rt.tx.update)
    port = _port_mini(variables)
    named = [(n, p) for n, p in port.named_parameters()
             if not n.startswith(("image_encoder.norm_head.",
                                  "image_encoder.head."))]
    opt = t_loop.TrainOptimizer(named, t_loop.build_runtime(tcfg, 4,
                                                            device="cpu"))
    rng = np.random.default_rng(11)
    applied = []
    for _ in range(8):
        grads = jax.tree.map(lambda p: (1e-2 * rng.normal(size=p.shape)
                                        ).astype(np.float32), params)
        updates, opt_state = update(grads, opt_state, params)
        params = jax.tree.map(np.asarray, optax.apply_updates(params,
                                                              updates))
        tg = sam_state_dict_from_flax({"params": grads, "batch_stats":
                                       variables["batch_stats"]}, CLASSES)
        for n, p in named:
            p.grad = tg[n].clone()
        applied.append(opt.step())
    assert applied == [False, True] * 4
    want = sam_state_dict_from_flax({"params": params, "batch_stats":
                                     variables["batch_stats"]}, CLASSES)
    start = sam_state_dict_from_flax(variables, CLASSES)
    for n, p in named:
        assert not torch.equal(p.detach(), start[n]), n
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=0, atol=1e-6, err_msg=n)


def test_three_steps_match_jax(mini, batch, mesh):
    jmodel, variables = mini
    images, labels = batch
    jcfg, tcfg = _jax_cfg(lr=1e-3, warmup_period=2, epochs=1,
                          layer_lr_decay=0.8)
    rt = j_loop.build_runtime(jcfg, steps_per_epoch=3, mesh=mesh)
    init, step = j_loop.make_train_step(jmodel, rt)
    trainable, frozen, stats, opt_state = init(variables)
    port = _port_mini(variables)
    pinit, pstep = t_loop.make_train_step(
        port, t_loop.build_runtime(tcfg, 3, device="cpu"))
    pstate = pinit()
    rng = np.random.default_rng(2)
    for k in range(3):
        x = images + 0.1 * k * rng.normal(size=images.shape).astype(
            np.float32)
        trainable, stats, opt_state, metrics = step(
            trainable, frozen, stats, opt_state, jnp.asarray(x),
            jnp.asarray(labels))
        got = pstep(pstate, x, labels)
        assert float(got["total_loss"]) == pytest.approx(
            float(metrics["total_loss"]), rel=1e-4), k


def test_eval_matches_jax(mini, batch):
    jmodel, variables = mini
    images, labels = batch
    ref = j_eval.evaluate_model(jmodel, jax.tree.map(jnp.asarray, variables),
                                [(images, labels)] * 2, CLASSES,
                                verbose=False)
    port = _port_mini(variables)
    got = t_eval.evaluate_model(port, [(images, labels)] * 2, CLASSES,
                                verbose=False)
    for key in ("iou", "dice"):
        np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=1e-6)
    _, tcfg = _jax_cfg()
    rt = t_loop.build_runtime(tcfg, 1, device="cpu")
    init, _ = t_loop.make_train_step(port, rt)
    loss, dsc = t_loop.make_eval_step(port, rt, CLASSES)(init(), images,
                                                         labels)
    jlogits, _ = jax.jit(lambda v, x: jmodel.apply(v, x))(
        variables, jnp.asarray(images))
    jl = jnp.asarray(labels)
    assert float(loss) == pytest.approx(
        float(j_losses.combined_loss(jlogits, jl)[0]), rel=1e-5)
    assert float(dsc) == pytest.approx(float(j_losses.dice_coeff_multi_class(
        jnp.argmax(jlogits, axis=1), jl, CLASSES)), abs=1e-6)


# --- data, prompts, GAN --------------------------------------------------------

def _png_folder(root, n=6, size=(40, 52), empty=(2,)):
    """n RGB images and label masks as PNGs, a CSV list; the masks at
    ``empty`` have no foreground."""
    from PIL import Image

    img_dir, mask_dir = root / "img", root / "mask"
    img_dir.mkdir()
    mask_dir.mkdir()
    rng = np.random.default_rng(4)
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w]
    rows = []
    for i in range(n):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        mask = np.zeros((h, w), np.uint8)
        if i not in empty:
            mask[(yy - h / 2 - i) ** 2 + (xx - w / 3) ** 2 < 60] = 1
            mask[xx > w - 8 - i] = 2
        Image.fromarray(img).save(img_dir / f"{i}.png")
        Image.fromarray(mask).save(mask_dir / f"{i}.png")
        rows.append(f"{i}.png,{i}.png")
    (root / "list.csv").write_text("\n".join(rows) + "\n")
    return str(img_dir), str(mask_dir), str(root / "list.csv")


@pytest.mark.parametrize("normalize_type,targets",
                         [("sam", "multi_all"), ("medsam", "combine_all")])
def test_public_dataset_matches_jax(tmp_path, normalize_type, targets):
    """Samples bit-equal to the JAX package's: train augmentation, the
    same seed, filter_empty, prompts and batch_iterator's order, under
    SAM and MedSAM normalisation and both target layouts."""
    pytest.importorskip("PIL", reason="both packages' datasets read PNGs "
                        "with PIL")
    folders = _png_folder(tmp_path)
    kw = dict(phase="train", image_size=32, out_size=8, seed=3,
              normalize_type=normalize_type, targets=targets)
    ref = j_data.PublicDataset(*folders, **kw).filter_empty()
    got = t_data.PublicDataset(*folders, **kw).filter_empty()
    assert got.rows == ref.rows and len(got) == 5
    for i in range(len(ref)):
        a, b = ref[i], got[i]
        for key in ("image", "mask"):
            assert np.array_equal(a[key], b[key]) and \
                a[key].dtype == b[key].dtype, (i, key)
    for prompt in ("point", "box"):
        pk = dict(kw, if_prompt=True, prompt_type=prompt)
        a, b = (j_data.PublicDataset(*folders, **pk)[0],
                t_data.PublicDataset(*folders, **pk)[0])
        assert sorted(a) == sorted(b)
        for key in a:
            assert np.array_equal(a[key], b[key]), (prompt, key)
    ref_batches = list(j_data.batch_iterator(
        j_data.PublicDataset(*folders, **kw), 2, seed=1))
    got_batches = list(t_data.batch_iterator(
        t_data.PublicDataset(*folders, **kw), 2, seed=1))
    assert len(got_batches) == len(ref_batches) == 3
    for (ri, rm), (gi, gm) in zip(ref_batches, got_batches):
        assert np.array_equal(ri, gi) and np.array_equal(rm, gm)


def test_prompts_match_jax():
    yy, xx = np.mgrid[0:40, 0:50]
    mask = (((yy - 12) ** 2 + (xx - 15) ** 2 < 50).astype(np.int32)
            + 2 * ((yy - 30) ** 2 + (xx - 38) ** 2 < 30))
    for fn, kw in (("get_first_point", dict(rng=None)),
                   ("get_top_boxes", dict(k=3)),
                   ("mask_to_box", dict(rng=None))):
        for m in (mask, np.zeros_like(mask)):
            args = {k: (np.random.default_rng(7) if k == "rng" else v)
                    for k, v in kw.items()}
            ref = getattr(j_prompts, fn)(m, **args)
            args = {k: (np.random.default_rng(7) if k == "rng" else v)
                    for k, v in kw.items()}
            got = getattr(t_prompts, fn)(m, **args)
            ref = ref if isinstance(ref, tuple) else (ref,)
            got = got if isinstance(got, tuple) else (got,)
            for r, g in zip(ref, got):
                assert np.array_equal(r, g) and r.dtype == g.dtype, fn


def test_gan_matches_jax():
    """WGAN-GP penalty and discriminator loss, JAX's interpolation draw
    passed to the port; a two-layer discriminator with the same weights."""
    rng = np.random.default_rng(8)
    w1 = rng.normal(size=(12, 16)).astype(np.float32) / 4
    b1 = 0.1 * rng.normal(size=16).astype(np.float32)
    w2 = rng.normal(size=(16, 1)).astype(np.float32) / 4
    real = rng.normal(size=(4, 3, 2, 2)).astype(np.float32)
    fake = rng.normal(size=(4, 3, 2, 2)).astype(np.float32)

    def j_disc(p, x):
        h = jnp.tanh(x.reshape(x.shape[0], -1) @ p["w1"] + p["b1"])
        return h @ p["w2"]

    params = {"w1": jnp.asarray(w1), "b1": jnp.asarray(b1),
              "w2": jnp.asarray(w2)}
    key = jax.random.PRNGKey(3)
    ref_gp = j_gan.gradient_penalty(j_disc, params, jnp.asarray(real),
                                    jnp.asarray(fake), key)
    ref_loss, _ = j_gan.discriminator_loss(j_disc, params, jnp.asarray(real),
                                           jnp.asarray(fake), key)
    eps = np.asarray(jax.random.uniform(key, (4, 1, 1, 1)))

    disc = torch.nn.Sequential(torch.nn.Flatten(), torch.nn.Linear(12, 16),
                               torch.nn.Tanh(),
                               torch.nn.Linear(16, 1, bias=False))
    with torch.no_grad():
        disc[1].weight.copy_(torch.from_numpy(w1.T))
        disc[1].bias.copy_(torch.from_numpy(b1))
        disc[3].weight.copy_(torch.from_numpy(w2.T))
    r, f, e = (torch.from_numpy(a) for a in (real, fake, eps))
    gp = t_gan.gradient_penalty(disc, r, f, eps=e)
    loss, _ = t_gan.discriminator_loss(disc, r, f, eps=e)
    assert float(gp) == pytest.approx(float(ref_gp), abs=1e-5)
    assert float(loss) == pytest.approx(float(ref_loss), abs=1e-5)
    opt = torch.optim.SGD(disc.parameters(), lr=0.1)
    before = disc[1].weight.clone()
    t_gan.update_d(disc, opt, r, f, eps=e)
    assert not torch.equal(before, disc[1].weight)


def test_visutils_match_jax(tmp_path):
    """eval_seg equal to the JAX package's; vis_image draws the same
    figure (the PNG bytes of both); create_logger writes its file."""
    pytest.importorskip("matplotlib", reason="vis_image draws with it")
    from tee_optical_flow_torch.train import visutils as t_vis
    from tee_optical_flow_tpu.train import visutils as j_vis

    rng = np.random.default_rng(6)
    logits = rng.normal(size=(2, 16, 16)).astype(np.float32)
    masks = (rng.uniform(size=(2, 16, 16)) > 0.6).astype(np.float32)
    assert t_vis.eval_seg(logits, masks) == j_vis.eval_seg(logits, masks)
    images = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    pred = rng.integers(0, 3, (2, 16, 16))
    paths = [vis.vis_image(images, pred, pred[::-1],
                           str(tmp_path / name / "panel.png"))
             for vis, name in ((t_vis, "port"), (j_vis, "jax"))]
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    logger = t_vis.create_logger(str(tmp_path / "log"), phase="val")
    logger.info("written")
    assert len(os.listdir(tmp_path / "log")) == 1


# --- config, checkpoints, the loop, the CLIs -----------------------------------

def test_train_config_json_round_trips(tmp_path):
    j = j_config.TrainConfig(num_cls=5, finetune_type="lora",
                             lora_layers=[0, 2], layer_lr_decay=0.8,
                             grad_accum=2, mesh_data_axis=1)
    j.to_json(str(tmp_path / "a.json"))
    t = t_config.TrainConfig.from_json(str(tmp_path / "a.json"))
    assert t.to_dict() == j.to_dict()
    t.to_json(str(tmp_path / "b.json"))
    assert j_config.TrainConfig.from_json(str(tmp_path / "b.json")) == j
    assert t_config.TrainConfig().to_dict() == \
        j_config.TrainConfig().to_dict()


def _arrays_dataset(n, seed, size=SIZE, out=OUT):
    """(images, labels) of n 64x64 frames of a disc whose size and place
    vary with the frame: a learnable two-class task."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    imgs, labs = [], []
    for _ in range(n):
        cy, cx, r = rng.uniform(20, 44), rng.uniform(20, 44), \
            rng.uniform(8, 16)
        disc = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        img = 0.2 * rng.normal(size=(size, size, 3)) + disc[..., None]
        imgs.append(img.astype(np.float32))
        step = size // out
        labs.append(disc[::step, ::step].astype(np.int32))
    return np.stack(imgs), np.stack(labs)


def _batches(images, labels, b=2):
    return lambda: ((images[i:i + b], labels[i:i + b])
                    for i in range(0, len(images), b))


class _Interrupted(Exception):
    pass


def test_resume_ends_bit_equal(tmp_path):
    """Two epochs straight against one epoch, an interruption, and a
    resume from train_state.pt: the final model and optimizer equal bit
    for bit (an unaugmented dataset: the augmentation generator is in
    neither package's snapshot)."""
    images, labels = _arrays_dataset(4, 1)
    finals = []
    for mode in ("straight", "resumed"):
        d = str(tmp_path / mode)
        cfg = t_config.TrainConfig(num_cls=2, image_size=SIZE, out_size=OUT,
                                   epochs=2, b=2, lr=1e-3, warmup_period=1,
                                   eval_interval=1, dir_checkpoint=d,
                                   layer_lr_decay=0.8, grad_accum=2)
        model = t_registry.build_sam_vit_t(2, SIZE, device="cpu", seed=4)
        calls = []

        def train_batches():
            calls.append(1)
            if mode == "resumed" and len(calls) == 2:
                raise _Interrupted
            return _batches(images, labels)()

        kw = dict(writer=_Writer(), save_state_every=1)
        if mode == "resumed":
            with pytest.raises(_Interrupted):
                t_loop.train_model(model, train_batches,
                                   _batches(images, labels), cfg, 2, **kw)
            assert os.path.exists(os.path.join(d, "train_state.pt"))
            model = t_registry.build_sam_vit_t(2, SIZE, device="cpu",
                                               seed=5)
            out = t_loop.train_model(model, _batches(images, labels),
                                     _batches(images, labels), cfg, 2,
                                     resume=True, **kw)
        else:
            out = t_loop.train_model(model, train_batches,
                                     _batches(images, labels), cfg, 2, **kw)
        state, epoch, iters = t_checkpoint.load_train_state(d)
        assert (epoch, iters) == (2, 4)
        finals.append((out["model"].state_dict(), state))
    (m0, s0), (m1, s1) = finals
    for key in m0:
        assert torch.equal(m0[key], m1[key]), key
    opt0, opt1 = s0["optimizer"]["optimizer"], s1["optimizer"]["optimizer"]
    for idx in opt0["state"]:
        for k, v in opt0["state"][idx].items():
            assert torch.equal(v, opt1["state"][idx][k]), (idx, k)
    assert s0["optimizer"]["scheduler"]["last_epoch"] == \
        s1["optimizer"]["scheduler"]["last_epoch"] == 2


class _Writer:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, name, value, step):
        self.scalars.append((name, value, step))

    def close(self):
        pass


@pytest.mark.parametrize("policy", ["vanilla", "adapter", "lora"])
def test_checkpoint_serves_the_trained_model(tmp_path, monkeypatch, policy):
    """train_model writes checkpoint_best.pth and args.json; the
    registry's load of it gives the trained model's logits bit for bit,
    and load_segmentor (the registry bound to image_size 64, as the run
    trained) its labels. Also the tensorboard scalars' names and steps."""
    images, labels = _arrays_dataset(4, 2)
    d = str(tmp_path / "run")
    cfg = t_config.TrainConfig(
        num_cls=2, image_size=SIZE, out_size=OUT, epochs=1, b=2, lr=1e-3,
        warmup_period=1, dir_checkpoint=d, finetune_type=policy,
        if_encoder_adapter=policy == "adapter", encoder_adapter_depths=[2],
        if_mask_decoder_adapter=policy == "adapter")
    build = dict(adapter_stages=(2,), use_decoder_adapter=True) \
        if policy == "adapter" else {}
    model = t_registry.build_sam_vit_t(2, SIZE, device="cpu", seed=6,
                                       **build)
    lora = t_lora.init_lora(model, rank=2, seed=1) if policy == "lora" \
        else None
    writer = _Writer()
    out = t_loop.train_model(model, _batches(images, labels),
                             _batches(images, labels), cfg, 2,
                             lora_params=lora, writer=writer)
    assert out["best_dsc"] > 0
    assert [s[0] for s in writer.scalars[:4]] == [
        "info/lr", "info/total_loss", "info/loss_ce", "info/loss_dice"]
    assert {s[0] for s in writer.scalars} == {
        "info/lr", "info/total_loss", "info/loss_ce", "info/loss_dice",
        "eval/loss", "eval/dice"}
    sched = t_schedule.warmup_poly_schedule(1e-3, 1, 2)
    assert [s[1:] for s in writer.scalars if s[0] == "info/lr"] == \
        [(sched(1), 1), (sched(2), 2)]
    assert os.path.exists(os.path.join(d, "args.json"))
    x = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        if lora is not None:
            merged = t_lora.merge_lora(dict(model.named_parameters()), lora)
            trained = torch.func.functional_call(model, merged, (x,))[0]
        else:
            trained = model(x)[0]
        loaded = t_registry.build_sam_vit_t(
            2, SIZE, device="cpu", checkpoint=os.path.join(
                d, "checkpoint_best.pth"), **build)
        assert torch.equal(loaded(x)[0], trained)
    monkeypatch.setitem(t_registry.sam_model_registry, "vit_t",
                        lambda **kw: t_registry.build_sam_vit_t(
                            image_size=SIZE, **kw))
    frames = (np.random.default_rng(3).integers(0, 256, (3, 48, 40, 3))
              .astype(np.uint8))
    served = t_process.load_segmentor(d, model_dtype="float32",
                                      device="cpu")(frames)
    if lora is None:
        ref = make_clip_segmentor(model)(frames)
    else:
        ref = make_clip_segmentor(loaded)(frames)
    assert np.array_equal(served, ref)


def test_cli_train_then_val(tmp_path, capsys):
    """cli.train at --image_size 64 for 2 epochs on the CPU writes
    args.json and checkpoint_best.pth; cli.val reads them and prints the
    JAX CLI's JSON keys."""
    pytest.importorskip("PIL", reason="the CLIs read PNG files")
    img, mask, lst = _png_folder(tmp_path, n=4, size=(64, 64), empty=())
    run = str(tmp_path / "run")
    rc = t_cli_train.main([
        "--dir_checkpoint", run, "--img_folder", img, "--mask_folder", mask,
        "--train_img_list", lst, "--val_img_list", lst, "--num_cls", "3",
        "--image_size", "64", "--out_size", "16", "--epochs", "2", "-b",
        "2", "--warmup_period", "2", "--device", "cpu"])
    assert rc == 0
    assert sorted(os.listdir(run)) == sorted(
        ["args.json", "checkpoint_best.pth"] +
        (["log"] if os.path.isdir(os.path.join(run, "log")) else []))
    cfg = j_config.TrainConfig.from_json(os.path.join(run, "args.json"))
    assert (cfg.num_cls, cfg.image_size, cfg.epochs) == (3, 64, 2)
    capsys.readouterr()
    assert t_cli_val.main(["--dir_checkpoint", run, "--img_folder", img,
                           "--mask_folder", mask, "--img_list", lst,
                           "--device", "cpu"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(result) == ["dice", "iou"]
    assert len(result["iou"]) == len(result["dice"]) == 3


def test_adapter_model_loads_a_checkpoint_without_adapters(tmp_path):
    """--sam_ckpt of a model without adapters (mobile_sam.pt's keys) into
    an adapter run's model: every other weight loads, the adapters keep
    their seeded values; a key that does not fit still raises."""
    plain = t_registry.build_sam_vit_t(3, SIZE, device="cpu", seed=7)
    path = str(tmp_path / "plain.pth")
    torch.save(plain.state_dict(), path)
    build = dict(adapter_stages=(1,), use_decoder_adapter=True)
    fresh = t_registry.build_sam_vit_t(3, SIZE, device="cpu", **build)
    loaded = t_registry.build_sam_vit_t(3, SIZE, device="cpu",
                                        checkpoint=path, **build)
    for key, value in loaded.state_dict().items():
        ref = fresh if "_Adapter." in key else plain
        assert torch.equal(value, ref.state_dict()[key]), key
    bad = dict(plain.state_dict())
    bad.pop("mask_decoder.iou_token.weight")
    torch.save(bad, path)
    with pytest.raises(RuntimeError, match="iou_token"):
        t_registry.build_sam_vit_t(3, SIZE, device="cpu", checkpoint=path,
                                   **build)


def test_refusals_and_empty_trainable_sets(tmp_path, monkeypatch):
    """A data axis above the devices raises ShardingError, as the JAX
    package's make_mesh does: TrainConfig(mesh_data_axis=2) on the CPU,
    and cli.train's --model_axis 2 or --data_axis 4 on one card (refused
    before anything runs on it). A policy that selects no parameter
    raises ValueError."""
    from tee_optical_flow_torch.exceptions import ShardingError

    with pytest.raises(ShardingError, match="mesh 2x1 != 1 devices"):
        t_loop.build_runtime(t_config.TrainConfig(mesh_data_axis=2), 1,
                             device="cpu")
    argv = ["--dir_checkpoint", str(tmp_path), "--img_folder", "i",
            "--mask_folder", "m", "--train_img_list", "t",
            "--val_img_list", "v"]
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        for extra, msg in ((["--model_axis", "2"], "not divisible"),
                           (["--data_axis", "4"], "mesh 4x1 != 1 devices")):
            with pytest.raises(ShardingError, match=msg):
                t_cli_train.main(argv + extra)
    model = t_registry.build_sam_vit_t(3, SIZE, device="cpu")
    rt = t_loop.build_runtime(t_config.TrainConfig(), 1, device="cpu")
    for policy in ("adapter", "lora"):
        init, _ = t_loop.make_train_step(model, rt, finetune_type=policy)
        with pytest.raises(ValueError, match="ZERO trainable"):
            init()
