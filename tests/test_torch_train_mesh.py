"""The port's SAM fine-tuning on a ('data', 'model') mesh of CPU ranks
(gloo, one process per mesh entry, started by parallel/launch.py over a
file store) against its one-process step on the same global batch.

The model is the mini vit_t-shaped arch of tests/conftest.py (image 64,
embed dims (16, 32, 40, 80), heads (1, 2, 2, 2), 3 classes) with
adapters in TinyViT stages 1-3 and in the decoder, seeded random weights
(norm scales 1 + 0.1 N, biases and batch means 0.1 N, batch variances
1 + 0.1 |N|, so that no batch norm's mean is zero in exact arithmetic),
global batch 4, float32, AdamW lr 1e-3 with warmup 2 and layer decay
0.8. The ranks run tee_optical_flow_torch.train.mesh_steps.run_steps,
which imports nothing of JAX; so does the one-process reference.

Meshes: 2x1 (the batch split, cross-replica batch norms, the gradient
sum), 2x2 with sam_param_shardings (also the model split: MLPs split
between their products, TinyViT's qkv blocks holding whole heads, the
decoder's out_proj slicing its input), and 1x4 (qkv blocks that split
heads: gathered before the head split).

Tolerances (from CPU runs of these tests; the differences are float32
sums taken in another order):
  * each of 3 steps' loss within 1e-5 relative (measured <= 1e-7);
  * one step's gradients within GRAD_REL of each tensor's max-abs
    (measured 8.3e-6 at worst on these data; on weights and data drawn
    from seeds 0-5 in place of these, 1.0e-5 to 1.6e-5, the worst on an
    adapter bias whose entries are sums that cancel to 2% of the largest
    gradient; the wrong conventions read far above it on seed 0:
    per-rank batch norms 3.1, a gradient without its B_r/B share 1.0);
    tensors that are zero
    in exact arithmetic (attention k-projection biases, biases right
    before a train-mode batch norm) hold ~1e-9 noise, as in
    tests/test_torch_train.py, and must stay under GRAD_NOISE x the
    largest gradient. LoRA factors on a split model: within
    LORA_SPLIT_GRAD_REL (measured 6.2e-4 on the decoder's q_proj factors
    at 2x2, 7e-6 at 2x2 without the split): a factor's gradient is
    b^T dW, which sums the merged weight's gradient dW over typical
    entries, while dW is held to GRAD_REL of its largest entry, which is
    tens of times the typical one;
  * running statistics after that step within 1e-6 of the largest of
    their kind (mean or variance) over the model's batch norms (measured
    4.5e-7): a running mean that is a sum cancelling to near zero has no
    relative digits to hold;
  * eval loss within 1e-5 relative, DSC within 1e-6;
  * parameters after the 3 steps: each tensor's move from its start
    within UPDATE_REL of the one-process move (L2; measured 5.3e-3 at
    worst). Entry by entry they
    cannot be held as tests/test_torch_train.py holds the optimizer on
    identical gradients: AdamW moves an entry by about lr x its
    gradient's sign at first, so an entry whose gradient lies near the
    gradients' float32 difference moves its own way (measured 1.4e-4 on 2
    of neck.2's 36,864 entries, whose gradients are 6e-6 of the
    tensor's largest). Tensors and entries whose gradient is under the
    noise bound above (the k-part of a fused qkv bias, for one) move by
    their noise's sign and are not compared; nor are parameters without
    a gradient (they only decay);
  * the whole train-state snapshot reloads bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from tee_optical_flow_torch import config as t_config
from tee_optical_flow_torch.cli import process as t_process
from tee_optical_flow_torch.cli import train as t_cli_train
from tee_optical_flow_torch.exceptions import ShardingError
from tee_optical_flow_torch.models import lora as t_lora
from tee_optical_flow_torch.models import registry as t_registry
from tee_optical_flow_torch.models.sam import Sam, make_clip_segmentor
from tee_optical_flow_torch.models.tinyvit import TinyViT
from tee_optical_flow_torch.parallel import collectives
from tee_optical_flow_torch.parallel.launch import LaunchError, launch
from tee_optical_flow_torch.parallel.mesh import backend_for, make_mesh
from tee_optical_flow_torch.train import loop as t_loop
from tee_optical_flow_torch.train import losses as t_losses
from tee_optical_flow_torch.train.mesh_steps import run_steps

torch.set_num_threads(1)

# the mini arch's fused-qkv head counts (conftest.MINI_HEADS_BY_DIM; not
# imported: the file runs on the card with --noconftest, and the conftest
# imports JAX)
MINI_HEADS_BY_DIM = {32: 2, 40: 2, 80: 2}

MINI = dict(embed_dims=(16, 32, 40, 80), depths=(1, 1, 2, 1),
            num_heads=(1, 2, 2, 2), window_sizes=(4, 4, 4, 4), neck_dim=64)
ADAPTERS = (1, 2, 3)
SIZE, OUT, CLASSES, BATCH = 64, 16, 3, 4
LOSS_REL = 1e-5
GRAD_REL = 3e-5
LORA_SPLIT_GRAD_REL = 1e-3
GRAD_NOISE = 1e-7
STATS_REL = 1e-6
UPDATE_REL = 1e-2
MODEL = {"arch": "tinyvit",
         "tinyvit": dict(img_size=SIZE, adapter_stages=ADAPTERS, **MINI),
         "sam": dict(num_classes=CLASSES, image_size=SIZE, embed_dim=64,
                     use_decoder_adapter=True)}
CFG = dict(num_cls=CLASSES, image_size=SIZE, out_size=OUT, lr=1e-3,
           warmup_period=2, epochs=1, layer_lr_decay=0.8)
# name -> (make_train_step keyword arguments, TrainConfig extras, boxes)
POLICIES = {
    "vanilla": ({}, {}, False),
    "frozen_encoder": ({"if_update_encoder": False}, {}, False),
    "adapter": ({"finetune_type": "adapter"}, {}, False),
    "lora": ({"finetune_type": "lora", "heads_by_dim": MINI_HEADS_BY_DIM},
             {}, False),
    "remat": ({"remat": True}, {}, False),
    "grad_accum": ({}, {"grad_accum": 2}, False),
    "boxes": ({}, {}, True),
}
MESHES = {"2x1": ((2, 1), False), "2x2": ((2, 2), True),
          "1x4": ((1, 4), True)}


def _mini():
    return Sam(TinyViT(**MODEL["tinyvit"]), **MODEL["sam"])


def _randomise(model, seed):
    """Seeded values over the registry's init (see the module
    docstring)."""
    rng = np.random.default_rng(seed)
    t_registry.init_weights(model, seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if not t.is_floating_point():
                continue
            z = torch.from_numpy(rng.normal(size=t.shape).astype(np.float32))
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "running_var":
                t.copy_(1 + 0.1 * z.abs())
            elif leaf in ("bias", "running_mean", "attention_biases"):
                t.copy_(0.1 * z)
            elif leaf == "weight" and t.ndim == 1:
                t.copy_(1 + 0.1 * z)
    return model


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The weights (with LoRA factors whose B is seeded 0.05 N, so both
    factors get gradients) and 3 global batches with boxes, as files."""
    root = tmp_path_factory.mktemp("mesh")
    model = _randomise(_mini(), 1)
    lora = t_lora.init_lora(model, rank=4, seed=0)
    rng = np.random.default_rng(9)
    for fac in lora.values():
        for k in fac:
            if k.startswith("b"):
                fac[k] = torch.from_numpy(
                    0.05 * rng.normal(size=fac[k].shape).astype(np.float32))
            fac[k] = fac[k].detach()
    torch.save({"model": model.state_dict(), "lora": lora},
               root / "weights.pt")
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:OUT, 0:OUT]
    train = []
    for k in range(3):
        images = rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)
        labels = np.stack([
            ((yy - 4 - 2 * j - k) ** 2 + (xx - 7 - j) ** 2 < 12 + 4 * j)
            .astype(np.int32) + (xx > 12 - j) * (j % 2)
            for j in range(BATCH)]).astype(np.int32)
        boxes = np.asarray([[8 + j, 10, 40 + 4 * j, 50] for j in
                            range(BATCH)], np.float32)
        train.append((images, labels, boxes))
    torch.save({"train": train, "eval": train[1][:2]}, root / "batches.pt")
    return str(root / "weights.pt"), str(root / "batches.pt")


def _specs(files, mesh, shard, policies=POLICIES):
    weights, batches = files
    n, m = mesh
    out = []
    for name in policies:
        kw, extra, boxes = POLICIES[name]
        out.append(dict(model=MODEL, weights=weights, batches=batches,
                        cfg=dict(CFG, **extra),
                        policy=dict({"finetune_type": "vanilla"}, **kw),
                        boxes=boxes, mesh=mesh, devices=["cpu"] * (n * m),
                        shard=shard, steps=3, timed=int(name == "vanilla")))
    return out


@pytest.fixture(scope="module")
def reference(files):
    return dict(zip(POLICIES, run_steps(_specs(files, (1, 1), False))))


class _Interrupted(Exception):
    pass


def _train_runs(spec, runs):
    """loop.train_model of the mini on ``spec``'s mesh, on this rank:
    for each (dir_checkpoint, epochs, stop, resume) of ``runs``, a model
    from the weights file trains on the train batches for ``epochs``
    epochs, or is interrupted (an exception from the batches) as the
    epoch after ``stop`` epochs begins (None: not); it evaluates every
    epoch and writes train_state.pt every epoch; rank 0 writes the
    files."""
    data = torch.load(spec["batches"], weights_only=False)
    n, m = spec["mesh"]
    for dir_checkpoint, epochs, stop, resume in runs:
        epoch = iter(range(epochs + 1))

        def train_batches():
            if next(epoch) == stop:
                raise _Interrupted
            return iter([(x, y) for x, y, _ in data["train"]])

        model = _mini()
        model.load_state_dict(torch.load(spec["weights"], weights_only=False)
                              ["model"], strict=True)
        cfg = t_config.TrainConfig(**dict(
            spec["cfg"], epochs=epochs, dir_checkpoint=dir_checkpoint,
            eval_interval=1, finetune_type=spec["policy"]["finetune_type"]))
        try:
            t_loop.train_model(
                model, train_batches, lambda: iter([data["eval"]]), cfg,
                len(data["train"]),
                mesh=make_mesh(n, m, devices=spec["devices"]),
                resume=resume, save_state_every=1)
        except _Interrupted:
            pass


def _rank_work(specs, train_spec=None, runs=()):
    """One rank's run_steps(specs), then its _train_runs(train_spec,
    runs)."""
    out = run_steps(specs)
    if runs:
        _train_runs(train_spec, runs)
    return out


@pytest.fixture(scope="module")
def ranks(files, tmp_path_factory):
    """{mesh: [each rank's {policy: results}]}: one launch per world size
    (the 4 ranks run the 2x2 specs, then the 1x4 ones: vanilla and LoRA;
    the 2 ranks then run train_model on the 2x1 mesh: 2 epochs straight,
    into ``out["train"]["straight"]``, and 1 epoch, interrupted, then
    resumed to 2, into ``out["train"]["resumed"]``)."""
    root = tmp_path_factory.mktemp("train_model")
    dirs = {k: str(root / k) for k in ("straight", "resumed")}
    runs = [(dirs["straight"], 2, None, False),
            (dirs["resumed"], 2, 1, False),
            (dirs["resumed"], 2, None, True)]
    out = {"train": dirs}
    for world, keys in ((2, ["2x1"]), (4, ["2x2", "1x4"])):
        specs, names = [], []
        for key in keys:
            mesh, shard = MESHES[key]
            pols = list(POLICIES) if key != "1x4" else ["vanilla", "lora"]
            specs += _specs(files, mesh, shard, pols)
            names += [(key, p) for p in pols]
        train = (specs[0], runs) if world == 2 else (None, ())
        res = launch(_rank_work, (specs,) + train,
                     devices=["cpu"] * world, threads=1, timeout=600)
        for key in keys:
            out[key] = [{p: r for (k, p), r in zip(names, rank) if k == key}
                        for rank in res]
    return out


def _initial(files):
    """The parameters the runs start from, under the trainable names."""
    w = torch.load(files[0], weights_only=False)
    out = dict(w["model"])
    out.update({f"lora/{site}/{k}": t for site, fac in w["lora"].items()
                for k, t in fac.items()})
    return out


WORST = {}


def _compare(got, ref, initial, tag):
    """Errors of a mesh's results against the one-process ones, as the
    module docstring states them; the worst of each kind goes to WORST."""
    worst = WORST.setdefault(tag, {"loss": 0.0, "grad": 0.0, "stats": 0.0,
                                   "update": 0.0})
    for a, b in zip(got["losses"], ref["losses"]):
        assert a == pytest.approx(b, rel=LOSS_REL), (got["losses"],
                                                     ref["losses"])
        worst["loss"] = max(worst["loss"], abs(a - b) / abs(b))
    assert sorted(got["grads"]) == sorted(ref["grads"])
    gmax = max(float(v.abs().max()) for v in ref["grads"].values())
    noise = set()
    for name, r in ref["grads"].items():
        g = got["grads"][name]
        assert g.shape == r.shape, name
        scale = float(r.abs().max())
        if scale < GRAD_NOISE * gmax:
            noise.add(name)
            assert float(g.abs().max()) < GRAD_NOISE * gmax, name
            continue
        err = float((g - r).abs().max())
        bound = (LORA_SPLIT_GRAD_REL if name.startswith("lora/")
                 and got["split"] else GRAD_REL)
        assert err <= bound * scale, (name, err, scale)
        worst["grad"] = max(worst["grad"], err / scale)
    for kind in ("running_mean", "running_var"):
        keys = [k for k in ref["stats"] if k.endswith(kind)]
        scale = max(float(ref["stats"][k].abs().max()) for k in keys)
        for k in keys:
            err = float((got["stats"][k] - ref["stats"][k]).abs().max())
            assert err <= STATS_REL * scale, (k, err, scale)
            worst["stats"] = max(worst["stats"], err / scale)
    assert got["eval"][0] == pytest.approx(ref["eval"][0], rel=LOSS_REL)
    assert got["eval"][1] == pytest.approx(ref["eval"][1], abs=1e-6)
    for name, r in ref["params"].items():
        if name in noise or name not in ref["grads"]:
            continue
        kept = ref["grads"][name].abs() >= GRAD_NOISE * gmax
        moved = float((r - initial[name]).detach()[kept].norm())
        err = float((got["params"][name] - r).detach()[kept].norm())
        assert err <= UPDATE_REL * moved, (name, err, moved)
        worst["update"] = max(worst["update"], err / moved)
    assert got["reloaded"]


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_mesh_step_matches_one_process(files, reference, ranks, mesh,
                                       policy):
    got = ranks[mesh][0][policy]
    _compare(got, reference[policy], _initial(files), mesh)
    assert got["backend"] == "gloo"
    # every rank holds the same whole gradients, running statistics and
    # train-state snapshot
    for other in ranks[mesh][1:]:
        o = other[policy]
        for k, v in got["grads"].items():
            assert torch.equal(o["grads"][k], v), k
        for k, v in got["stats"].items():
            assert torch.equal(o["stats"][k], v), k
        assert o["losses"] == got["losses"]
    snap, ref = got["snapshot"]["model"], reference[policy]["snapshot"]
    assert {k: v.shape for k, v in snap.items()} == {
        k: v.shape for k, v in ref["model"].items()}


@pytest.mark.parametrize("policy", ["vanilla", "lora"])
def test_heads_split_by_the_model_axis(files, reference, ranks, policy):
    """1x4: the mini's 2-head qkv blocks split heads, so they gather before
    the head split; the LoRA delta's blocks merge into the shards."""
    _compare(ranks["1x4"][0][policy], reference[policy], _initial(files),
             "1x4")
    print("worst errors by mesh:", WORST)


def test_split_weights_and_batch_norms(ranks):
    """The 2x2 run split the rule's weights (each MLP pair, each qkv and
    proj, the decoder's out_proj) and made every batch norm a
    cross-replica one; 1x4 kept the batch norms (a data axis of 1)."""
    got = ranks["2x2"][0]["vanilla"]
    assert got["batchnorms"] == got["cross_replica"] == 18
    assert ranks["1x4"][0]["vanilla"]["cross_replica"] == 0
    split = got["split"]
    assert "image_encoder.layers.1.blocks.0.mlp.fc1.bias" in split
    assert "image_encoder.layers.1.blocks.0.mlp.fc2.bias" not in split
    assert "mask_decoder.transformer.layers.0.self_attn.out_proj.weight" \
        in split
    assert not any("q_proj" in k or "Adapter" in k for k in split)
    # 4 TinyViT blocks x (qkv, proj, fc1, fc2); the decoder's 2 layers x
    # (3 out_proj, lin1, lin2) and its final out_proj
    assert sum(k.endswith(".weight") for k in split) == 4 * 4 + 2 * 5 + 1


def test_loss_shares_sum_to_the_global_loss():
    """The convention of parallel/collectives: the ranks' shares (B_r / B)
    x combined_loss of their rows sum to combined_loss of the batch,
    dice (a mean over samples and classes) and CE (a mean over pixels)
    alike."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(size=(6, CLASSES, OUT, OUT))
                              .astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, CLASSES, (6, OUT, OUT)))
    whole = t_losses.combined_loss(logits, labels)
    for n in (2, 3, 6):
        parts = [t_losses.combined_loss(logits[r * 6 // n:(r + 1) * 6 // n],
                                        labels[r * 6 // n:(r + 1) * 6 // n])
                 for r in range(n)]
        for i in range(3):
            share = sum(p[i] / n for p in parts)
            assert float(share) == pytest.approx(float(whole[i]), rel=1e-6)


def test_backend_rule():
    assert backend_for(["cpu"] * 2) == "gloo"
    assert backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert backend_for(["cuda:0", "cpu"]) == "gloo"


def test_split_model_checkpoint_and_resume(files, ranks, tmp_path,
                                           monkeypatch):
    """The 2x2 run's train-state snapshot (its weights split by
    sam_param_shardings) holds whole tensors, which the one-card model
    loads strictly, and every rank took its blocks of it back bit for bit
    (as a resume does). train_model on the 2x1 mesh: rank 0 writes a
    checkpoint_best.pth that load_segmentor serves; 2 epochs straight and
    1 epoch then a resume from train_state.pt end on the same model and
    optimizer state."""
    from tee_optical_flow_torch.models.convert import load_torch_checkpoint
    from tee_optical_flow_torch.train import checkpoint as t_checkpoint

    split = [r["vanilla"] for r in ranks["2x2"]]
    assert split[0]["split"] and all(r["reloaded"] for r in split)
    _mini().load_state_dict(split[0]["snapshot"]["model"], strict=True)

    straight, resumed = ranks["train"]["straight"], ranks["train"]["resumed"]
    model = _mini()
    ckpt = torch.load(os.path.join(straight, "checkpoint_best.pth"),
                      weights_only=False)
    model.load_state_dict(ckpt, strict=True)
    finals = [t_checkpoint.load_train_state(d) for d in (straight, resumed)]
    assert [f[1:] for f in finals] == [(2, 6), (2, 6)]
    (s0, _, _), (s1, _, _) = finals
    for key, v in s0["model"].items():
        assert v.shape == model.state_dict()[key].shape, key
        assert torch.equal(v, s1["model"][key]), key
    opt0, opt1 = s0["optimizer"]["optimizer"], s1["optimizer"]["optimizer"]
    for idx, st in opt0["state"].items():
        for k, v in st.items():
            assert torch.equal(v, opt1["state"][idx][k]), (idx, k)
    monkeypatch.setitem(t_registry.sam_model_registry, "vit_t",
                        lambda checkpoint=None, **kw: load_torch_checkpoint(
                            checkpoint, _mini()).eval())
    frames = (np.random.default_rng(3).integers(0, 256, (2, 48, 40, 3))
              .astype(np.uint8))
    served = t_process.load_segmentor(straight, model_dtype="float32",
                                      device="cpu")(frames)
    assert np.array_equal(served, make_clip_segmentor(model)(frames))


# --- the launcher's failures -------------------------------------------------

def test_short_batch_fails_the_launch(files):
    """A global batch the data axis does not divide raises ValueError on
    the ranks, as the JAX package's device_put does, and the launch
    fails."""
    weights, batches = files
    data = torch.load(batches, weights_only=False)
    short = os.path.join(os.path.dirname(batches), "short.pt")
    torch.save({"train": [tuple(a[:3] for a in data["train"][0])],
                "eval": data["eval"]}, short)
    spec = _specs((weights, short), (2, 1), False, ["vanilla"])
    with pytest.raises(LaunchError, match="divisible|divide"):
        launch(run_steps, (spec,), devices=["cpu"] * 2, threads=1,
               timeout=300)


def test_rank_errors_fail_the_launch():
    """A rank that dies or hangs fails the launch (one that raises:
    test_short_batch_fails_the_launch)."""
    import time

    with pytest.raises(LaunchError, match="died"):
        launch(os._exit, (3,), devices=["cpu"] * 2, timeout=120)
    with pytest.raises(LaunchError, match="still running"):
        launch(time.sleep, (60,), devices=["cpu"] * 2, timeout=2)


def test_one_process_mesh_and_too_few_devices():
    """build_runtime takes a 1x1 mesh; a data axis above the devices
    raises ShardingError, as the JAX package's make_mesh; a mesh of two
    entries without a process group of two ranks raises ShardingError
    naming the launcher."""
    model = t_registry.build_sam_vit_t(3, SIZE, device="cpu")
    cfg = t_config.TrainConfig(num_cls=3, image_size=SIZE, out_size=OUT)
    rt = t_loop.build_runtime(cfg, 1, mesh=make_mesh(1, 1, ["cpu"]))
    assert rt.procs is None and rt.device == torch.device("cpu")
    init, step = t_loop.make_train_step(model, rt)
    images = np.zeros((2, SIZE, SIZE, 3), np.float32)
    labels = np.zeros((2, OUT, OUT), np.int32)
    assert np.isfinite(float(step(init(), images, labels)["total_loss"]))
    with pytest.raises(ShardingError, match="mesh 2x1 != 1 devices"):
        t_loop.build_runtime(t_config.TrainConfig(mesh_data_axis=2), 1,
                             device="cpu")
    with pytest.raises(ShardingError, match="launch"):
        t_loop.build_runtime(cfg, 1, mesh=make_mesh(2, 1, ["cpu"] * 2))


def test_build_runtime_stays_on_the_callers_device(monkeypatch):
    """With two cards and no process group, build_runtime without a mesh
    runs on the caller's device (a 1x1 mesh), at mesh_data_axis None or
    1; a data axis above 1 asks for the JAX package's mesh over every
    card, which needs the ranks."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for axis in (None, 1):
        cfg = t_config.TrainConfig(num_cls=3, image_size=SIZE,
                                   out_size=OUT, mesh_data_axis=axis)
        for device in ("cuda:1", "cpu"):
            rt = t_loop.build_runtime(cfg, 1, device=device)
            assert rt.procs is None and rt.device == torch.device(device)
            assert rt.mesh.shape == {"data": 1, "model": 1}
    model = t_registry.build_sam_vit_t(3, SIZE, device="cpu")
    init, step = t_loop.make_train_step(model, rt)
    images = np.zeros((2, SIZE, SIZE, 3), np.float32)
    labels = np.zeros((2, OUT, OUT), np.int32)
    assert np.isfinite(float(step(init(), images, labels)["total_loss"]))
    with pytest.raises(ShardingError, match="launch"):
        t_loop.build_runtime(t_config.TrainConfig(mesh_data_axis=2), 1,
                             device="cuda:0")


# --- cli.train on CPU ranks --------------------------------------------------

def _png_folder(root, n=4):
    from PIL import Image

    img_dir, mask_dir = root / "img", root / "mask"
    img_dir.mkdir()
    mask_dir.mkdir()
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    rows = []
    for k in range(n):
        Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3))
                        .astype(np.uint8)).save(img_dir / f"{k}.png")
        lab = ((yy - 30 - 2 * k) ** 2 + (xx - 28) ** 2 < 200).astype(
            np.uint8) + (xx > 50)
        Image.fromarray(lab.astype(np.uint8)).save(mask_dir / f"{k}.png")
        rows.append(f"{k}.png,{k}.png")
    lst = root / "list.csv"
    lst.write_text("\n".join(rows) + "\n")
    return str(img_dir), str(mask_dir), str(lst)


def test_cli_train_on_ranks_serves_the_one_process_model(tmp_path,
                                                         monkeypatch):
    """cli.train --device cpu at --data_axis 2 (2 ranks) and at
    --data_axis 1 --model_axis 2 (2 replicas, as the JAX package's
    model axis) writes a checkpoint that load_segmentor serves; its
    weights equal the 1-process run's within the step tolerances."""
    pytest.importorskip("PIL", reason="the CLI reads PNG files")
    img, mask, lst = _png_folder(tmp_path)
    base = ["--img_folder", img, "--mask_folder", mask,
            "--train_img_list", lst, "--val_img_list", lst, "--num_cls",
            "3", "--image_size", str(SIZE), "--out_size", str(OUT),
            "--epochs", "1", "-b", "4", "--warmup_period", "2",
            "--device", "cpu"]
    runs = {}
    for key, axes in (("one", []), ("data", ["--data_axis", "2"]),
                      ("model", ["--data_axis", "1", "--model_axis", "2"])):
        run = str(tmp_path / key)
        assert t_cli_train.main(["--dir_checkpoint", run] + base + axes) == 0
        assert {"args.json", "checkpoint_best.pth"} <= set(os.listdir(run))
        runs[key] = torch.load(os.path.join(run, "checkpoint_best.pth"),
                               weights_only=False)
    one = runs["one"]
    for key in ("data", "model"):
        for name, ref in one.items():
            got = runs[key][name]
            if not ref.is_floating_point():
                assert torch.equal(got, ref), (key, name)
                continue
            assert float((got - ref).abs().max()) <= 1e-4 * max(
                float(ref.abs().max()), 1.0), (key, name)
    monkeypatch.setitem(t_registry.sam_model_registry, "vit_t",
                        lambda **kw: t_registry.build_sam_vit_t(
                            image_size=SIZE, **kw))
    frames = (np.random.default_rng(3).integers(0, 256, (2, 48, 40, 3))
              .astype(np.uint8))
    served = t_process.load_segmentor(str(tmp_path / "data"),
                                      model_dtype="float32",
                                      device="cpu")(frames)
    model = t_registry.build_sam_vit_t(3, SIZE, device="cpu")
    model.load_state_dict(runs["data"])
    assert np.array_equal(served, make_clip_segmentor(model)(frames))


def test_cli_data_axis_above_the_cards_raises(tmp_path, monkeypatch):
    """On one card, --data_axis 2 raises ShardingError before anything
    runs on it, as the JAX package's make_mesh does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = ["--dir_checkpoint", str(tmp_path / "run"), "--img_folder", "i",
            "--mask_folder", "m", "--train_img_list", "t",
            "--val_img_list", "v"]
    with pytest.raises(ShardingError, match="mesh 2x1 != 1 devices"):
        t_cli_train.main(argv + ["--data_axis", "2"])
    with pytest.raises(ShardingError, match="not divisible"):
        t_cli_train.main(argv + ["--model_axis", "2"])


def test_collective_tally_per_step(ranks):
    """One vanilla 2x1 step: one all-reduce per batch norm in the forward
    and one in the backward (Sum x, Sum x^2 and the count: 2C + 1
    floats), one flat all-reduce of every gradient (of the parameters
    the step reached), one of the metrics;
    no model-axis collective. One 2x2 step adds the model axis's, and
    one broadcast of the gradients the model axis holds whole."""
    got = ranks["2x1"][0]["vanilla"]
    tally = got["tally"]
    n_params = sum(t.numel() for t in got["grads"].values())
    assert tally["sum"]["calls"] == 2 * got["batchnorms"]
    assert tally["grads"] == dict(tally["grads"], calls=1,
                                  bytes=4 * n_params)
    assert tally["values"]["calls"] == 1
    assert tally["copy"]["calls"] == tally["reduce"]["calls"] == 0
    assert tally["broadcast"]["calls"] == 0
    split = ranks["2x2"][0]["vanilla"]["tally"]
    assert split["reduce"]["calls"] > 0 and split["copy"]["calls"] > 0
    # the gradients of what the model axis holds whole, from its first rank
    assert split["broadcast"]["calls"] == 1
    collectives.reset_tally()
    assert all(v == {"calls": 0, "bytes": 0, "seconds": 0.0}
               for v in collectives.TALLY.values())


@pytest.mark.cuda
def test_two_cards_over_nccl(files):
    """Two cards of their own: nccl, and the 2x1 step equal to one
    process's on the first card (skips without two cards)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    ref = run_steps([dict(s, devices=["cuda:0"]) for s in
                     _specs(files, (1, 1), False, ["vanilla"])])[0]
    got = launch(run_steps, ([dict(s, devices=["cuda:0", "cuda:1"]) for s in
                              _specs(files, (2, 1), False, ["vanilla"])],),
                 devices=["cuda:0", "cuda:1"], timeout=600)[0][0]
    assert got["backend"] == "nccl"
    for a, b in zip(got["losses"], ref["losses"]):
        assert a == pytest.approx(b, rel=1e-4)
