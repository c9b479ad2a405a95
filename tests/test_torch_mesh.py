"""The port's device mesh (parallel/mesh.py), the sharded clip flow and
the sharded segmentor, against the JAX package's on the CPU.

JAX's tests run on an 8-device virtual CPU mesh (tests/conftest.py);
torch has one CPU device, so the port's CPU mesh names it 8 times. The
sharded flow is held bit-equal to the port's own unsharded solve (pairs
are independent: each keeps its own state and stop flags), and once to
the JAX package's sharded flow within 1e-3 px, the bound the port's
TV-L1 is held to against JAX (tests/test_torch_tvl1.py). The sharded
segmentor's labels and logits are held equal to the single-device
segmentor's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax

from tee_optical_flow_torch.config import (
    OpticalFlowCalculationConfig as TorchConfig,
)
from tee_optical_flow_torch.exceptions import ShardingError as TShardingError
from tee_optical_flow_torch.flow import pipeline as t_pipe
from tee_optical_flow_torch.models.registry import build_sam_vit_t
from tee_optical_flow_torch.models.sam import make_clip_segmentor
from tee_optical_flow_torch.parallel import mesh as t_mesh
from tee_optical_flow_tpu.config import (
    OpticalFlowCalculationConfig as JaxConfig,
)
from tee_optical_flow_tpu.exceptions import ShardingError as JShardingError
from tee_optical_flow_tpu.flow import pipeline as j_pipe
from tee_optical_flow_tpu.parallel import mesh as j_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8

# reduced solves that keep what makes a pair's result its own: TV-L1 with
# the epsilon stop (per-pair flags), medians and bicubic warps; DeepFlow
# with the matching seed
TVL1_CFG = dict(tvl1_nscales=2, tvl1_zoom_factor=0.5, tvl1_warps=2,
                tvl1_outer_iterations=3, tvl1_inner_iterations=10)
DEEPFLOW_CFG = dict(deepflow_nscales=2, deepflow_fp_iterations=1,
                    deepflow_sor_iterations=5)
# the JAX comparison at the smallest size that still pads (3 pairs over a
# data axis of 4): one XLA compile of the partitioned solve, ~20 s here
JAX_CFG = dict(tvl1_nscales=2, tvl1_zoom_factor=0.5, tvl1_warps=2,
               tvl1_outer_iterations=2, tvl1_inner_iterations=5,
               tvl1_median_filtering=False, tvl1_use_pallas=False)
JAX_FLOW_ATOL = 1e-3


def _frames(rng, n=6, h=48, w=48):
    """A smoothed texture shifted by 0.5 px per frame."""
    img = ndimage.gaussian_filter(rng.uniform(size=(h, w)), 3.0)
    img = ((img - img.min()) / (img.max() - img.min()) * 255.0)
    return np.stack([ndimage.shift(img, (0, 0.5 * i), order=3,
                                   mode="nearest")
                     for i in range(n)]).astype(np.float32)


@pytest.mark.parametrize("data_axis,model_axis", [
    (None, 1), (8, 1), (4, 2), (2, 4), (None, 4)])
def test_make_mesh_matches_jax(data_axis, model_axis):
    j = j_mesh.make_mesh(data_axis, model_axis)
    t = t_mesh.make_mesh(data_axis, model_axis, devices=CPU8)
    assert t.shape == dict(j.shape)
    assert t.devices.shape == j.devices.shape
    assert t.axis_names == j.axis_names
    assert t.data_devices == [torch.device("cpu")] * j.shape["data"]
    for nd in (1, 3):
        assert t_mesh.batch_sharding(t, nd).spec == tuple(
            j_mesh.batch_sharding(j, nd).spec)
    assert t_mesh.replicated_sharding(t).spec == tuple(
        j_mesh.replicated_sharding(j).spec)


@pytest.mark.parametrize("data_axis,model_axis", [(3, 1), (None, 3),
                                                  (2, 2)])
def test_make_mesh_raises_as_jax(data_axis, model_axis):
    with pytest.raises(JShardingError) as j:
        j_mesh.make_mesh(data_axis, model_axis)
    with pytest.raises(TShardingError) as t:
        t_mesh.make_mesh(data_axis, model_axis, devices=CPU8)
    assert str(t.value) == str(j.value)


def test_make_mesh_needs_a_card_unless_given_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_mesh.make_mesh()
    assert t_mesh.make_mesh(devices=["cpu"]).shape == {"data": 1, "model": 1}


def test_shard_batch_matches_jax(rng):
    batch = {"images": rng.normal(size=(8, 3, 4)).astype(np.float32),
             "labels": [np.arange(16, dtype=np.int32).reshape(8, 2)]}
    j = j_mesh.shard_batch(j_mesh.make_mesh(4, 2), batch)
    t = t_mesh.shard_batch(t_mesh.make_mesh(4, 2, devices=CPU8), batch)
    for jleaf, tleaf in ((j["images"], t["images"]),
                         (j["labels"][0], t["labels"][0])):
        assert len(tleaf) == 4
        by_row = {}
        for shard in jleaf.addressable_shards:
            by_row[shard.index[0].start] = np.asarray(shard.data)
        starts = sorted(by_row)
        for k, chunk in enumerate(tleaf):
            assert chunk.device == torch.device("cpu")
            np.testing.assert_array_equal(chunk.numpy(), by_row[starts[k]])
    t_chunks = t_mesh.shard_batch(t_mesh.make_mesh(devices=CPU8),
                                  torch.arange(8.0))
    assert [float(c) for c in t_chunks] == list(range(8))


def test_shard_batch_refuses_an_indivisible_batch_as_jax(rng):
    x = rng.normal(size=(5, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="divisible by 8"):
        j_mesh.shard_batch(j_mesh.make_mesh(), x)
    with pytest.raises(ValueError, match=r"divisible by the data axis \(8\)"):
        t_mesh.shard_batch(t_mesh.make_mesh(devices=CPU8), {"x": x})


def test_initialize_distributed_forms_a_gloo_group():
    """A no-op for one process, as in JAX; two processes on the CPU form
    a gloo group over tcp://localhost and all-reduce across it."""
    assert t_mesh.initialize_distributed() is None
    assert t_mesh.initialize_distributed("localhost:1", 1, 0) is None
    assert not torch.distributed.is_initialized()
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = (
        "import sys, torch\n"
        "from tee_optical_flow_torch.parallel import initialize_distributed\n"
        "rank = int(sys.argv[1])\n"
        f"initialize_distributed('localhost:{port}', 2, rank, device='cpu')\n"
        "x = torch.tensor([rank + 1.0])\n"
        "torch.distributed.all_reduce(x)\n"
        "print(torch.distributed.get_backend(), "
        "torch.distributed.get_world_size(), float(x))\n"
        "torch.distributed.destroy_process_group()\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        finally:
            p.kill()
        assert p.returncode == 0, err
        outs.append(out.split())
    assert outs == [["gloo", "2", "3.0"]] * 2


@pytest.mark.parametrize("algo", ["TVL1", "deepflow"])
@pytest.mark.parametrize("shards", [4, 8])
def test_sharded_flow_is_bit_equal_to_unsharded(rng, algo, shards):
    """6 frames -> 5 pairs, padded to 8 (4 shards of 2, 8 shards of 1),
    under the config's spatial bucketing (48 -> 64): every pair's flow
    bit-equal to the unsharded solve of the whole clip."""
    frames = _frames(rng)
    cfg = TorchConfig(**(TVL1_CFG if algo == "TVL1" else DEEPFLOW_CFG))
    single = t_pipe.compute_clip_flow(frames, algo, cfg, device="cpu")
    mesh = t_mesh.make_mesh(devices=["cpu"] * shards)
    got = t_pipe.compute_clip_flow_sharded(frames, mesh, algo, cfg)
    assert got.shape == (5, 48, 48, 2) and got.device.type == "cpu"
    assert torch.equal(got, single)
    assert abs(float(got[0, 16:-16, 16:-16, 0].median()) - 0.5) < 0.2


def test_sharded_flow_matches_jax(rng):
    frames = _frames(rng, n=4, h=32, w=32)
    ref = np.asarray(j_pipe.compute_clip_flow_sharded(
        frames, j_mesh.make_mesh(4, 2), "TVL1", JaxConfig(**JAX_CFG)))
    got = t_pipe.compute_clip_flow_sharded(
        frames, t_mesh.make_mesh(4, 2, devices=CPU8), "TVL1",
        TorchConfig(**JAX_CFG))
    assert got.shape == ref.shape == (3, 32, 32, 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=JAX_FLOW_ATOL, rtol=0)


@pytest.mark.parametrize("weights_int8", [False, True])
def test_sharded_segmentor_equals_single(rng, weights_int8):
    """vit_t at 64 px: labels from a 2-entry mesh (micro-batch 4 split
    in two) equal the single-device segmentor's, on the host path and the
    device path, and so do the logits of one micro-batch; a repeated
    device holds one replica."""
    torch.manual_seed(0)
    model = build_sam_vit_t(num_classes=3, image_size=64, device="cpu")
    clip = (rng.uniform(size=(10, 40, 44, 3)) * 255).astype(np.uint8)
    kw = dict(micro_batch=4, weights_int8=weights_int8)
    single = make_clip_segmentor(model, **kw)
    sharded = make_clip_segmentor(
        model, mesh=t_mesh.make_mesh(devices=["cpu"] * 2), **kw)
    np.testing.assert_array_equal(sharded(clip), single(clip))
    gray = torch.from_numpy(clip[..., 0])
    assert torch.equal(sharded.labels_device(gray, (40, 44)),
                       single.labels_device(gray, (40, 44)))
    assert sharded.resident_weight_bytes == single.resident_weight_bytes
    from tee_optical_flow_torch.models.sam import preprocess_frames

    x = preprocess_frames(torch.from_numpy(clip[:4]), 64)
    with torch.no_grad():
        whole = single.forward(x)[0]
        halves = torch.cat([sharded.forward(x[:2])[0],
                            sharded.forward(x[2:])[0]])
    assert float((whole - halves).abs().max()) <= 1e-5 * float(
        whole.abs().max())
