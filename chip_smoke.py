"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from tee_optical_flow_torch/csrc/ into
one library (one nvcc compile per source, all at once, then one link),
drives the port's paths through their entry points under the production
config, and holds each kernel against its plain PyTorch version on the
card at the shapes its path gives it (K1 and K3 also on the very
arguments the TV-L1 and the DeepFlow path handed them):

  * TV-L1 (BASELINE config 1): a 33-frame 480x640 synthetic echo DICOM
    through process_video(mode="otsu", OF_algo="TVL1", no_saliency=True);
  * DeepFlow (BASELINE config 2): the same DICOM through
    process_video(mode="otsu", OF_algo="deepflow", no_saliency=True);
  * the K2 path: a 33-frame 600x800 synthetic echo DICOM through the
    same TV-L1 call; its finest level (608x800 after bucketing) is above
    K1's size rule and runs the block loop (K2's steps with the median
    fused in, inside the two-quiet-blocks stop), held against its plain
    version on the arguments the path handed it;
  * SAM (BASELINE config 3): the 480x640 DICOM through
    process_video(mode="RVIO_2class", OF_algo="TVL1", no_saliency=True)
    with the vit_t segmentor at its full 1024 width (seeded random
    weights, bfloat16, micro-batch 4): its masks held bit-equal to the
    port's clean_mask run on the CPU over the card's own labels, its flow
    to the TV-L1 bounds, 25 K1 calls;
  * the SAM model itself (phase_sam): float32 logits on the card against
    the CPU (TF32 off), bfloat16 against float32, micro-batch 1 against 4,
    and the segmentor's time per frame in each precision;
  * the fine-grained saliency map of the clip, card against CPU;
  * BASELINE config 4 (phase_cohort): the 480x640 clip through
    process_video(mode="RVIO_2class", OF_algo="TVL1", bkgd_comp="WASE",
    include_waveforms=True) with labels from the clip's geometry and
    synthetic ECG and arterial traces, then the port's dataset from the
    saved arrays in memory and the 69-value cohort row through both
    gates; WASE, the histogram packs, the AV centroid and the row held
    against their plain or CPU versions;
  * the analysis entry points (phase_peak_plots) on that dataset:
    cli.peak_plots.analyze_clip under five gating methods, the api's
    analyses and the overlay video's frames, held against their CPU
    recomputation (no plot or video file is written: the card's machine
    has no matplotlib or imageio);
  * BASELINE config 5 (phase_cli): three 33x480x640 DICOMs through the
    port's command line, cli.process.main --nchunks 2 with a checkpoint
    directory and a PipelineConfig JSON (RVIO_2class, saliency, WASE,
    waveforms, bfloat16), 25 K1 calls per clip, the first clip held
    against a direct process_video call;
  * SAM vit_t fine-tuning (phase_train) at full width (1024, out 256,
    SAM_CLASSES classes, batch 4, float32 parameters, AdamW lr 1e-4,
    weight decay 0.1) on the clip's frames with labels from its geometry,
    through the port's PublicDataset: the median ms per step (float32 and
    TF32), images per second, peak memory and the step's FLOPs; a 30-step
    overfit of one batch; 3 steps each of the adapter and LoRA policies;
    one step card against CPU in strict float32 (loss, every gradient,
    the eval DSC); and cli.train -> checkpoint_best.pth -> load_segmentor
    (labels equal to the trained model's) -> cli.process (25 K1 calls);
  * the ViT-Det SAM (phase_vitdet): vit_b at 1024 (seeded random
    weights) card against CPU in strict float32; cli.process over one
    33x480x640 DICOM with a vit_b checkpoint directory (args.json says
    vit_b) under config 5's PipelineConfig, in bfloat16 and in int8
    weights (25 K1 calls each, masks against the CPU's clean_mask, int8
    logits against bfloat16's), with the segmentor's time per frame,
    FLOPs, peak memory and resident weight bytes; vit_l and vit_h at full
    width and depth on one micro-batch in both; vit_b fine-tuning
    (vanilla, adapters on blocks, decoder-only LoRA; then cli.train --arch
    vit_b -> load_segmentor -> cli.process, 25 K1 calls); and the
    predictor, the automatic mask generator and torch.export on one
    frame;
  * vit_t fine-tuning on a ('data', 'model') mesh of processes
    (phase_train_mesh): the card named once per rank, over gloo, at full
    width in strict float32; data axis 2, model axis 2 with
    sam_param_shardings and 2x2, each held to the one-process step on
    the same batches (losses, gradients, the 27 running statistics, eval
    loss and DSC), with ms per step, bytes all-reduced and peak memory
    per rank; cli.train's launcher on 2 ranks -> checkpoint_best.pth ->
    load_segmentor (labels equal to the trained model's in rank 0) ->
    cli.process (25 K1 calls); cli.train --data_axis 2 refused with
    ShardingError on one card;
  * compressed DICOM and TV-L1 gamma (phase_compressed_gamma): the
    480x640 clip written uncompressed, RLE and JPEG-Lossless and read by
    the native C++ reader (csrc/dicomlite.cpp, built with g++), bit-equal;
    process_video(mode="otsu", OF_algo="TVL1") on the JPEG-Lossless file
    (25 K1 calls, its saved layout bit-equal to the uncompressed run's);
    process_video with tvl1_gamma=1.0 under the production config, whose
    5x5 medians launch the standalone CUDA median, held bit-equal on the
    path's own arguments; the JAX package's brightness-ramp case; the
    legacy shim's statistics against the CPU; PromptAutoEncoder at 1024
    card against CPU;
  * frame-axis data parallelism (phase_mesh): the main clip's pairs
    through flow/pipeline.compute_clip_flow_sharded on a 1- and a
    2-entry mesh of the one card (TV-L1; DeepFlow on 2), bit-equal to the
    unsharded solve, the launches of every shard counted, the host
    synchronisations of a 2-shard solve listed; the vit_t segmentor on
    the 2-entry mesh against the unsharded one; load_segmentor(
    data_axis=2) refused with ShardingError on one card;
  * the baseline network zoo (phase_baselines): every get_network entry
    and SmallDecoder at default widths, batch 4 at 256 (UNet also at
    1024), card against CPU, ms per batch, parameters, peak memory; one
    UNet AdamW step at 1024 in train mode; one WGAN-GP discriminator
    update through train/gan.
  * the masks' labelling kernel (phase_labelling, csrc/labelling.cu) on
    the complement of the Otsu masks of 40-frame 480x640 and 600x800
    stacks, connectivity 1 as the fills label them: bit-equal to the
    plain loop, its time, bound and device launches;
  * ViT-Det's attention kernel (phase_attention,
    csrc/relpos_attention.cu) at vit_h's and vit_b's global and windowed
    shapes: its error and the plain version's against a float32 attention,
    its time with and without the bias projections, the plain version's, torch's
    scaled_dot_product_attention with the bias materialised (a yardstick
    the port never calls), its bound and device launches; its launches on
    the vit_b paths and in the exported program (phase_vitdet).

It checks what comes out (schema, wall end-point error against the
analytic motion, launch counts per path, and the device launches per
call and per clip from the kernel library's own counter, which a
profiler trace may only undercount). Imports nothing of JAX.
``k3_tuning()`` and ``k2_tuning()`` (run on their own) time K3 and the
block loop under builds with other tiles and steps per launch;
``attention_tuning()`` times the attention kernel's geometries;
``attention_check()`` runs phase_attention alone,
``vitdet_check()`` phase_vitdet, ``compressed_gamma_check()``
phase_compressed_gamma (after phase_cohort, for its dataset),
``mesh_check()`` phase_mesh, ``baselines_check()`` phase_baselines and
``train_mesh_check()`` phase_train_mesh;
``batch_dependence()`` and ``unet_algorithms()`` print what lies behind
two of their findings. Exits non-zero,
with no result line, when there is no CUDA device or a phase fails.

Output: progress lines, each after the set-up headed by the card's name
and power limit (nvidia-smi); then, before the last line, the card's name
and power limit and one JSON line {"kernels": [...]} with each
kernel's launches on its path, error against its plain version, times and
bound; last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, at 700 W): HBM rate and
# float32 outside the tensor cores. bound_ms is the larger of the bytes a
# call must move over the first and the operations it does over the second
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# and the dense tensor-core peaks the SAM segmentor's share is read
# against: bfloat16, and TF32 (float32 matrix products with TF32 on)
BF16_DENSE_OPS_PER_S = 989e12
TF32_DENSE_OPS_PER_S = 495e12

CLIP_FRAMES, CLIP_H, CLIP_W = 33, 480, 640
# the K2 path's clip: 600x800 frames bucket to 608x800, whose finest level
# is above K1's size rule (ops/tvl1.per_iteration_stop)
K2_FRAMES, K2_H, K2_W = 33, 600, 800
K2_SHAPE = (608, 800)
FPS, SPACING_CM = 30, 0.05
# the clip's radial contraction c_k = A sin(2 pi k / period): a 16-frame
# cardiac cycle, up to ~2.2 px of wall motion per frame at 480x640
AMPLITUDE, PERIOD = 0.04, 16
# the main path's batch: 33 frames bucket to 40 (frame_bucket 8), 39 pairs
MAIN_PAIRS = 39

# operations per pixel, counted from the algorithm: a primal-dual step is
# 28 float ops in the primal and 28 in the dual (+5 for the epsilon
# error), a 5x5 median 9 + 66 compare-exchanges of 2 ops each per plane
OPS_STEP, OPS_ERR, OPS_MEDIAN_PLANE = 56, 5, 150
# bytes a step of K1 moves per pixel (neighbours and halos from cache): its
# fused step reads 11 planes and writes 6
K1_STEP_BYTES = (11 + 6) * 4
# and a median of u and v: each plane read once and written once
MEDIAN_BYTES = 2 * 2 * 4
# builds of the labelling kernel (csrc/labelling.cu: LB_R rounds a pass on
# an LB_EW x LB_EH extended tile, the tile and a halo of LB_R, one thread
# a column) that labelling_tuning compares with the default one. A
# pixel-round is 5 integer operations (four minimums and the foreground
# select); a labelling reads the mask (1 B) and writes the ids (4 B)
LB_VARIANTS = (
    {}, {"LB_R": 16, "LB_EH": 64, "LB_MIN_BLOCKS": 2},
    {"LB_R": 16, "LB_EH": 96, "LB_MIN_BLOCKS": 1},
    {"LB_R": 6, "LB_EH": 40, "LB_MIN_BLOCKS": 4},
    {"LB_EH": 40, "LB_MIN_BLOCKS": 4}, {"LB_EH": 56, "LB_MIN_BLOCKS": 2},
    {"LB_R": 10, "LB_EH": 56, "LB_MIN_BLOCKS": 2},
    {"LB_EW": 128, "LB_MIN_BLOCKS": 6})
OPS_LABEL_ROUND, LABEL_BYTES = 5, 1 + 4
# the clip cells' shapes: 33 frames bucket to 40
LABEL_SHAPES = ((40, CLIP_H, CLIP_W), (40, K2_H, K2_W))

# the attention kernel (csrc/relpos_attention.cu) at the shapes it runs in
# the served encoders (B, heads, h, w, hd): vit_h's global block on the SAM
# cell's micro-batch of 4 and a windowed block's 4 frames x 25 windows of
# 14x14 (hd 80), and vit_b's two (hd 64, the other geometry of the
# windowed blocks: 8 of vit_b's 12 blocks, 20 of vit_l's 24)
ATTN_SHAPES = {"vit_h_global": (4, 16, 64, 64, 80),
               "vit_h_window": (100, 16, 14, 14, 80),
               "vit_b_global": (4, 12, 64, 64, 64),
               "vit_b_window": (100, 12, 14, 14, 64)}
# grids between a window and a global block, one whose key tiles lie
# within a grid row (16x64), and the depth attention's 2x2, at vit_h's
# widths: where attention_tuning weighs the geometries
# (ops/attention_kernels.attention_geometry)
ATTN_TUNING_SHAPES = {"depth_2x2": (1024, 16, 2, 2, 80),
                      "grid_24x24": (4, 16, 24, 24, 80),
                      "grid_28x28": (4, 16, 28, 28, 80),
                      "grid_16x64": (4, 16, 16, 64, 80),
                      "grid_32x32": (4, 16, 32, 32, 80),
                      "grid_36x36": (4, 16, 36, 36, 80),
                      "grid_40x40": (4, 16, 40, 40, 80),
                      "grid_48x48": (4, 16, 48, 48, 80)}
ATTN_OPS_PER_S = 989.4e12
# vit_b's transformer blocks: one attention kernel launch each a micro-batch
VITB_BLOCKS = 12
# the tables' spread as the SAM cell draws them (sam_clip.draw_state):
# REL_POS_SPREAD / sqrt(hd); dense weights at 1/sqrt(fan-in), biases 0.1
REL_POS_SPREAD, ATTN_BIAS_SPREAD = 2.0, 0.1

# flow sanity on the wall: end-point error against the analytic motion.
# The port's CPU run of the same clip at the same settings measured a
# median of 0.013-0.033 px and a p95 of 0.065-0.078 px over three windows
# of pairs (motion 0.4-2.2 px); the bounds leave 3x of that
WALL_MEDIAN_EPE_PX, WALL_P95_EPE_PX = 0.1, 0.25
# the same for DeepFlow: cpu_wall_reference() (the port on the CPU at the
# production settings, pairs 0-1, 3-4 and 7-8, median motion 0.44-2.29
# px) measured a median of 0.034-0.044 px and a p95 of 0.098-0.119 px
DF_WALL_MEDIAN_EPE_PX, DF_WALL_P95_EPE_PX = 0.13, 0.36

# the SAM path: vit_t at 1024 with 3 classes (background, rv, av), seeded
# random weights, bfloat16 (the CLI's model_dtype) at micro-batch 4 (the
# CLI's); its masks are held bit-equal to the CPU clean_mask over windows
# of the card's labels around these frames (a frame's masks depend only
# on the labels of frames k-1 to k+2: tests/test_torch_segment.py)
SAM_SEED, SAM_CLASSES, SAM_MICRO_BATCH = 0, 3, 4
SAM_WINDOWS = (0, 16, 32)
# phase_sam's bounds. Float32 on the card against the CPU, TF32 off: the
# logits' max-abs difference under SAM_F32_ATOL and under SAM_F32_REL of
# their range, at least SAM_F32_AGREE of the argmax labels equal (float32
# rounding in another order; a label flips only on a near-tie). bfloat16
# against float32 on the card: at least SAM_BF16_AGREE of the labels
# equal and the max-abs logit error under SAM_BF16_REL of the range (on
# the CPU, vit_t at 128 measured 99.1-99.4% and 0.9-1.1%:
# tests/test_torch_sam.py)
SAM_F32_ATOL, SAM_F32_REL, SAM_F32_AGREE = 2e-3, 5e-4, 0.998
SAM_BF16_AGREE, SAM_BF16_REL = 0.97, 0.06

# the config-4 path (WASE, waveforms, the gated cohort row): the clip's
# 16-frame contraction cycle lasts one second at COHORT_FPS, so the 33
# frames hold two beats; a synthetic ECG (500 Hz) has an R wave at the
# start of each contraction, a synthetic arterial trace (125 Hz) a pulse a
# second. The labels come from the clip's geometry: rv the wall ring, av a
# disc at the ring centre of radius COHORT_AV_RADIUS x H, background the
# rest. Bounds: WASE against the float64 host background, COHORT_WASE_ATOL
# px (float32 sums over the clip in the card's order); the card's row
# against the CPU's host half, COHORT_ROW_RTOL relative on floats,
# integers equal; the AV centroid checked on the CPU at COHORT_CENTROID_
# FRAMES (a frame's centroid depends only on its own mask)
COHORT_FPS = 16.0
COHORT_AV_RADIUS = 0.06
COHORT_BEATS_S = (0.05, 1.05, 2.0)
COHORT_WASE_ATOL = 1e-5
COHORT_ROW_RTOL = 1e-5
COHORT_CENTROID_FRAMES = (0, 30)

# BASELINE config 5 through the port's command line (phase_cli): three
# 33x480x640 DICOMs (echo_clip at these seeds; the first is the main
# path's clip) with their _II/_ART companions, split over CLI_NCHUNKS
# chunk folders, RVIO_2class with the vit_t segmentor from a checkpoint
# directory (SAM_SEED's weights, bfloat16), WASE, saliency and waveforms
CLI_SEEDS = (0, 1, 2)
CLI_NCHUNKS = 2
# the analysis entry points (phase_peak_plots): cli.peak_plots.analyze_clip
# under each gate, on the config-4 phase's dataset
PEAK_METHODS = ("angle", "area", "ecg", "ecg_lazy", "arterial")

# SAM fine-tuning (phase_train): vit_t at 1024 (decoder out 256) with
# SAM_CLASSES classes, vanilla with the encoder updated, AdamW at lr 1e-4
# and weight decay 0.1, float32 parameters, batch TRAIN_BATCH. Timing: the
# median of TRAIN_TIMED steps after TRAIN_WARM, CUDA events per step (of
# TRAIN_PEFT_STEPS after TRAIN_WARM for the adapter and LoRA steps). The
# overfit check: TRAIN_OVERFIT_STEPS steps on one batch at a constant lr,
# the last loss at most TRAIN_OVERFIT_RATIO x the first. Card against CPU,
# one step at batch 1 in strict float32: the loss within TRAIN_LOSS_REL
# relative, each gradient within TRAIN_GRAD_REL x its tensor's max-abs;
# a tensor whose gradient is zero in exact arithmetic (attention
# k-projection biases, biases just before a batch norm) holds float32
# noise on both sides, and both must stay under TRAIN_GRAD_NOISE x the
# largest gradient (tests/test_torch_train.py states the same on the CPU
# against JAX). train -> serve: cli.train over TRAIN_CLI_FRAMES train and
# val frames for TRAIN_CLI_EPOCHS epochs
TRAIN_SEED, TRAIN_BATCH, TRAIN_LR, TRAIN_WD = 1, 4, 1e-4, 0.1
TRAIN_SIZE, TRAIN_OUT = 1024, 256
TRAIN_WARM, TRAIN_TIMED = 3, 20
TRAIN_OVERFIT_STEPS, TRAIN_OVERFIT_RATIO = 30, 0.7
TRAIN_PEFT_STEPS = 3
TRAIN_LOSS_REL, TRAIN_GRAD_REL, TRAIN_GRAD_NOISE = 1e-4, 1e-3, 1e-6
TRAIN_CLI_FRAMES, TRAIN_CLI_EPOCHS = (8, 4), 2

# the ViT-Det SAM (phase_vitdet): vit_b, vit_l and vit_h at 1024 with
# SAM_CLASSES classes and VITDET_SEED's random weights. vit_b in float32,
# TF32 off, card against CPU on one frame: logits within VITDET_F32_REL of
# their max-abs; bfloat16 labels against float32 on the card at least
# SAM_BF16_AGREE equal. The int8 segmentor's logits against the bfloat16
# one's on a micro-batch: within VITDET_INT8_REL of their max-abs (the JAX
# package's bound, tests/test_models.py). vit_b fine-tuning as phase_train
# does vit_t (batch TRAIN_BATCH, VITDET_TRAIN_STEPS timed steps after
# TRAIN_WARM; adapters on the CLI's default blocks VITDET_ADAPTER_BLOCKS);
# the mask generator on a VITDET_AMG_POINTS x VITDET_AMG_POINTS grid. The
# bfloat16 cli.process run's masks are held to the CPU's clean_mask at the
# frames of SAM_WINDOWS, the int8 and the trained runs' at VITDET_WINDOWS
# (each window costs ~15 s of CPU labelling)
VITDET_SEED = 0
VITDET_WINDOWS = (16,)
VITDET_F32_REL = 1e-3
VITDET_INT8_REL = 0.15
VITDET_TRAIN_STEPS = 5
VITDET_ADAPTER_BLOCKS = (0, 1, 10, 11)
VITDET_AMG_POINTS = 4

# the compressed-DICOM and gamma phase (phase_compressed_gamma): the main
# path's 33x480x640 clip written uncompressed, RLE and JPEG-Lossless and
# read through read_dicom_clip (DICOM_READS timed reads each, the least
# kept); TV-L1 with OpenCV's illumination term at GAMMA under the
# production config, held to the TV-L1 wall bounds; its standalone 5x5
# medians, GAMMA_MEDIANS_EPS0 per clip at epsilon 0 (5 levels x 5 warps x
# 10 outer iterations x u and v; counted on GAMMA_EPS0_FRAMES frames, as
# the count does not depend on the pairs); the JAX package's
# brightness-ramp case (tests/test_tvl1.py: 64x80, shift (1.5, -1.0) px,
# a 0-30 ramp; 3 scales, 5 warps, 6 x 20 iterations): median end-point
# error under GAMMA_RAMP_BOUND px at gamma 1 and over GAMMA_RAMP_PLAIN_MIN
# at gamma 0; the legacy shim's statistics against their CPU recomputation
# (COHORT_ROW_RTOL); PromptAutoEncoder at PAE_SIZE on PAE_FRAMES frames,
# float32, card against CPU within PAE_REL of the output's max-abs
GAMMA = 1.0
GAMMA_MEDIANS_EPS0 = 5 * 5 * 10 * 2
GAMMA_EPS0_FRAMES = 4
GAMMA_RAMP_BOUND, GAMMA_RAMP_PLAIN_MIN = 0.1, 0.5
DICOM_READS = 3
PAE_SIZE, PAE_FRAMES, PAE_REL = 1024, 4, 1e-4

# frame-axis data parallelism (phase_mesh): the main clip's 32 pairs
# through flow/pipeline.compute_clip_flow_sharded under the production
# config, TV-L1 on a mesh of MESH_SHARDS entries of the one card (2:
# ["cuda:0", "cuda:0"], two shards one after the other), DeepFlow on the
# 2-entry mesh: each pair's flow bit-equal to the unsharded
# tvl1_flow_pairs / deepflow_pairs on the card, every shard making the
# path's launches. The vit_t segmentor (SAM_SEED's weights, SAM_CLASSES,
# 1024) on the 2-entry mesh against the unsharded one at micro-batch
# SAM_MICRO_BATCH: in bfloat16 at least MESH_SEG_AGREE of the labels
# equal (each shard's batch of 2 may pick other cuDNN algorithms than a
# batch of 4), in float32 the logits within MESH_F32_REL of max-abs
MESH_SHARDS = (1, 2)
MESH_SEG_AGREE, MESH_F32_REL = 0.99, 1e-5

# the baseline network zoo (phase_baselines): every get_network entry
# and SmallDecoder at its default widths (get_network's num_classes 2),
# float32 with TF32 off, a batch of BASELINE_BATCH at BASELINE_SIZE (the
# trainer's out_size; the implicit critics on a 1-channel segmentation, a
# 3-channel image and a label), UNet also at BASELINE_UNET_SIZE (the
# trainer's image_size; its CPU check on one frame): the card's forward
# within BASELINE_REL of the max-abs of the same module's CPU forward.
# One AdamW step of UNet at BASELINE_UNET_SIZE with its train-mode batch
# statistics committed (BASELINE_TRAIN_STEPS timed after one), and one
# WGAN-GP discriminator update through train/gan on the Discriminator,
# its loss within BASELINE_REL of the CPU's
BASELINE_SEED, BASELINE_BATCH, BASELINE_SIZE = 0, 4, 256
BASELINE_UNET_SIZE, BASELINE_REL, BASELINE_TRAIN_STEPS = 1024, 1e-4, 3

# the TV-L1 path: 5 levels x 5 warps, one K1 call each; K1 is held against
# its plain version on the path's own arguments at the finest and the
# coarsest level
TV_LEVELS, TV_WARPS = 5, 5
K1_SHAPES = ((CLIP_H, CLIP_W), (197, 262))
# the device kernels of each source, summed per clip by the profiler; a
# K1 call must launch the first of csrc/tvl1.cu's once and none of the
# others
TVL1_DEVICE_KERNELS = ("outer_loop_kernel", "median5x5_kernel",
                       "block_sweep_kernel", "block_end_kernel")
DEEPFLOW_DEVICE_KERNELS = ("coefs_kernel", "sweep_kernel",
                           "resident_kernel")
LABEL_DEVICE_KERNELS = ("label_pass_kernel",)
DEVICE_KERNELS = {"tvl1.cu": TVL1_DEVICE_KERNELS,
                  "deepflow.cu": DEEPFLOW_DEVICE_KERNELS,
                  "labelling.cu": LABEL_DEVICE_KERNELS}

# the DeepFlow path: 5 levels x 3 fixed points, one K3 call each; K3 is
# held against its plain version at every level (the two coarsest with
# the matching term)
DF_LEVELS, DF_FP_ITERS = 5, 3
K3_SHAPES = ((CLIP_H, CLIP_W), (240, 320), (120, 160), (60, 80), (30, 40))
# K3's float32 operations per pixel, counted from the algorithm: per psi
# round 28 for the smoothness weight, 102 for the data term, the
# diffusivities and the 2x2 system (+21 with the matching term), and 30
# per SOR iteration (each pixel updated once per red-black pair)
OPS_DF_WEIGHTS, OPS_DF_COEFS, OPS_DF_MATCH, OPS_DF_SOR = 28, 102, 21, 30
# K3's tiled route as csrc/deepflow.cu builds it by default: S SOR
# iterations per sweep launch on an EW x EH extended tile (k3_tuning
# rebuilds it with others). Levels whose pair fits in one block's shared
# memory take the resident route instead (ops/deepflow_kernels.resident)
K3_S, K3_TILE = 4, (96, 64)
# the block loop as csrc/tvl1.cu builds it by default: at most S steps per
# sweep launch on an EW x EH extended tile (the tile and a halo of S), 512
# threads, two blocks per SM; k2_tuning rebuilds it with others
K2_S, K2_TILE = 5, (64, 40)
# k2_tuning's builds: the production one, other S, 1024 threads on the
# same tile, and one 1024-thread block per SM on larger tiles
K2_VARIANTS = (
    {}, {"K2_S": 4}, {"K2_S": 6}, {"K2_THREADS": 1024},
    {"K2_EW": 128, "K2_EH": 40, "K2_THREADS": 1024},
    {"K2_EW": 96, "K2_EH": 52, "K2_THREADS": 1024},
    {"K2_EW": 80, "K2_EH": 64, "K2_THREADS": 1024})
# a pair whose block delta came within this share of the threshold may
# freeze a block earlier or later on the card: the kernel sums the delta
# in another order than torch.sum
K2_NEAR = 1e-4
# k3_tuning's builds (-D overrides of those defaults): the production one,
# the tiled route at every size, other S, and a 64x48 extended tile of 512
# threads (two blocks per SM)
K3_VARIANTS = (
    {}, {"K3_RESIDENT": 0}, {"K3_S": 2}, {"K3_S": 3}, {"K3_S": 6},
    *({"K3_EW": 64, "K3_EH": 48, "K3_THREADS": 512, "K3_S": s}
      for s in (2, 3, 4, 6)))


def k3_device_launches(resident, psi_iters, sor_iters, s=K3_S):
    """Device launches of one K3 call."""
    return 1 if resident else psi_iters * (1 + -(-sor_iters // s))


def k3_own_bytes(b, h, w, match, psi_iters, sor_iters, resident, s=K3_S,
                 tile=K3_TILE):
    """Bytes the K3 kernels themselves move in one call (neighbours from
    cache). Resident: per psi round the 10 input planes (13 with match),
    then du/dv written once. Tiled, per psi round: the coefficients pass
    reads 10 input planes (13 with match) and du/dv (not in the first
    round) and writes w and 6 coefficients; each sweep launch reads du/dv
    (not the first launch) and the 7 planes over every extended tile's
    in-image pixels, halos included, and writes du/dv over the tiles."""
    n_in = 13 if match else 10
    npx = b * h * w
    if resident:
        return 4 * npx * (psi_iters * n_in + 2)
    ew, eh = tile
    tw, th = ew - 4 * s, eh - 4 * s
    ext = sum((min(ty * th - 2 * s + eh, h) - max(ty * th - 2 * s, 0))
              * (min(tx * tw - 2 * s + ew, w) - max(tx * tw - 2 * s, 0))
              for ty in range(-(-h // th)) for tx in range(-(-w // tw)))
    sweeps = -(-sor_iters // s)
    coef_planes = psi_iters * (n_in + 7) + 2 * (psi_iters - 1)
    sweep_planes_ext = psi_iters * sweeps * 9 - 2
    return 4 * (npx * coef_planes + b * ext * sweep_planes_ext
                + npx * 2 * psi_iters * sweeps)


def k2_device_launches(lib, outer_iters, inner_iters, epsilon):
    """Device launches of one block-loop call: per block the sweep
    launches of ``lib`` (tvl1_block_sweeps) and, with the stop, the
    block-end launch; frozen pairs' launches do no work but still count."""
    return outer_iters * (lib.tvl1_block_sweeps(inner_iters)
                          + (1 if epsilon > 0 else 0))


def k2_own_bytes(h, w, inner_iters, sweeps, use_median=True, s=K2_S,
                 tile=K2_TILE):
    """Bytes the block loop's kernels move per pair and block (neighbours
    and halos from cache). Each sweep launch loads the four constants, the
    dual field and the flow over every extended tile's in-image pixels and
    writes the six state planes over the image; with the median the first
    loads the flow over the tiles and two more pixels (the median's
    window) and writes the post-median flow, which the last reads back
    for the block delta."""
    ew, eh = tile
    tw, th = ew - 2 * s, eh - 2 * s

    def area(pad):
        return sum((min(ty * th - s - pad + eh + 2 * pad, h)
                    - max(ty * th - s - pad, 0))
                   * (min(tx * tw - s - pad + ew + 2 * pad, w)
                      - max(tx * tw - s - pad, 0))
                   for ty in range(-(-h // th)) for tx in range(-(-w // tw)))

    ext, npx = area(0), h * w
    planes = sweeps * (10 * ext + 6 * npx)
    if use_median:
        planes += 2 * (area(2) - ext) + 4 * npx
    return 4 * planes


def is_kernel(event_name, kernel):
    """Whether a profiler event names the kernel (a template instance
    too)."""
    return f"::{kernel}(" in event_name or f"::{kernel}<" in event_name


_T0 = time.perf_counter()
# the card's name and power limit (nvidia-smi), set by phase_setup: every
# progress line after it carries them, so each time it prints stands beside
# the card that measured it
_CARD = ""


def log(msg: str) -> None:
    card = f" | {_CARD}" if _CARD else ""
    print(f"[{time.perf_counter() - _T0:6.1f} s{card}] {msg}", flush=True)


def echo_clip(n: int, h: int, w: int, seed: int = 0):
    """(n, h, w) uint8 frames of the synthetic echo sector contracting by
    c_k about the ring centre, and the (n-1, h, w, 2) true flow of each
    consecutive pair in px (u = columns, v = rows)."""
    from tee_optical_flow_torch.synthetic import (
        bicubic_sample, echo_sector_masks, make_echo_pair,
    )

    img, _ = make_echo_pair(seed, h, w, contraction=0.0)
    sector = echo_sector_masks(h, w)["sector"]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    cy, cx = 0.55 * h, 0.5 * w
    cs = AMPLITUDE * np.sin(2 * np.pi * np.arange(n) / PERIOD)
    frames = np.empty((n, h, w), np.uint8)
    for k, c in enumerate(cs):
        f = bicubic_sample(img.astype(np.float64), xx + c * (xx - cx),
                           yy + c * (yy - cy))
        f[~sector] = 0.0
        frames[k] = np.round(np.clip(f, 0, 255))
    # frame k shows I(x_c + (1 + c_k)(x - x_c)): a point at x moves to
    # x_c + (1 + c_k)/(1 + c_{k+1}) (x - x_c) in frame k + 1
    s = (1 + cs[:-1]) / (1 + cs[1:]) - 1
    flow = np.stack([s[:, None, None] * (xx - cx)[None],
                     s[:, None, None] * (yy - cy)[None]], axis=-1)
    return frames, flow.astype(np.float32)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn() over reps calls, timed with CUDA events after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_abs(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def level_inputs(frames_u8, flow_px, device):
    """One warp's K1/K2 inputs at a finest pyramid level, as _tvl1_scale
    builds them: per-frame img2uint8 of the clip, the bicubic tiled warp
    (max_disp 17 at the finest level of max_disp 16) at the true flow."""
    import torch

    from tee_optical_flow_torch.ops.imaging import gray_from_clip, img2uint8
    from tee_optical_flow_torch.ops.warp import (
        centered_gradient, warp_many_shift_tiled2d,
    )

    images = img2uint8(gray_from_clip(
        torch.from_numpy(frames_u8).to(device)))
    i0, i1 = images[:-1].contiguous(), images[1:].contiguous()
    flow = torch.from_numpy(flow_px).to(device)
    u, v = flow[..., 0].contiguous(), flow[..., 1].contiguous()
    i1x, i1y = centered_gradient(i1)
    i1w, i1wx, i1wy = warp_many_shift_tiled2d(
        (i1, i1x, i1y), u, v, max_disp=17, local_r=8, kernel="bicubic")
    grad = i1wx * i1wx + i1wy * i1wy
    rho_c = i1w - i1wx * u - i1wy * v - i0
    zeros = torch.zeros_like(u)
    return [t.contiguous() for t in
            (rho_c, i1wx, i1wy, grad, u, v, zeros, zeros, zeros, zeros)]


def k1_active_work(args, *, outer_iters, inner_iters, epsilon, l_t, theta,
                   taut, **_):
    """(pair-steps, pair-medians) that the epsilon stop lets run on these
    inputs: the plain version's loop (tvl1_outer_loop_plain), counting
    the active pairs at each median and each step."""
    import torch

    from tee_optical_flow_torch.ops import tvl1_kernels as tk
    from tee_optical_flow_torch.ops.warp import median_filter_5x5_plain

    rho_c, i1wx, i1wy, grad = args[:4]
    state = list(args[4:])
    b, h, w = state[0].shape
    thresh = float(torch.tensor(epsilon * epsilon * h * w,
                                dtype=torch.float32))
    th, inv_grad = tk.derived_constants(grad, l_t)
    err = torch.full((b,), float("inf"), device=grad.device)
    steps = medians = 0
    for _ in range(outer_iters):
        medians += int((err > thresh).sum())
        state[0] = median_filter_5x5_plain(state[0], err=err, thresh=thresh)
        state[1] = median_filter_5x5_plain(state[1], err=err, thresh=thresh)
        for _ in range(inner_iters):
            act = err > thresh
            steps += int(act.sum())
            new = tk._plain_step(rho_c, i1wx, i1wy, th, inv_grad, *state,
                                 l_t=l_t, theta=theta, taut=taut)
            derr = torch.sum((new[0] - state[0]) ** 2
                             + (new[1] - state[1]) ** 2, dim=(1, 2))
            err = torch.where(act, derr, err)
            state = [torch.where(act[:, None, None], a, c)
                     for a, c in zip(new, state)]
    return steps, medians


def phase_setup():
    global _CARD
    import torch

    from tee_optical_flow_torch.ops import cuda_lib

    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = (smi.stdout.strip().splitlines() or ["nvidia-smi: no output"])[0]
    log(f"card: {card}")
    _CARD = card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cuda_lib.load_library()
    info = cuda_lib.build_info
    log(f"kernels built in {time.perf_counter() - t0:.1f} s (nvcc: "
        f"{info['seconds']:.1f} s, one compile per source in parallel, one "
        f"link), {info['path']}")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    from tee_optical_flow_torch.io import dicom_native

    t0 = time.perf_counter()
    dicom_native.native_available()
    log(f"native DICOM reader (csrc/dicomlite.cpp, g++) loaded in "
        f"{time.perf_counter() - t0:.1f} s: {dicom_native.build_info}")
    try:
        import h5py  # noqa: F401
        has_h5py = True
    except ImportError:
        has_h5py = False
    log(f"h5py present: {has_h5py}")
    return card, has_h5py


def phase_kernels(clip, truth):
    """K1 against its plain version at the main path's finest level, on
    inputs built from the true flow (phase_k1 holds it on the path's own
    arguments, phase_k2 the block loop, K2 and the median on the K2
    path's)."""
    import torch

    from tee_optical_flow_torch.ops import tvl1_kernels as tk

    dev = torch.device("cuda")
    lt, theta, taut = 0.15 * 0.3, 0.3, 0.25 / 0.3
    records = {}

    # the main path's finest level: all 39 pairs of the bucketed clip
    frames = np.concatenate([clip, np.repeat(clip[-1:], 7, axis=0)])
    flow = np.concatenate([truth, np.zeros_like(truth[:7])])
    args = level_inputs(frames, flow, dev)
    b, h, w = args[0].shape
    assert b == MAIN_PAIRS, b
    npx = b * h * w

    # K1 at the full 10 x 30 budget, epsilon 0 and the production 0.01
    kw = dict(outer_iters=10, inner_iters=30, use_median=True, l_t=lt,
              theta=theta, taut=taut)
    k1 = {}
    for eps, tol in ((0.0, 0.0), (0.01, 0.05)):
        got = tk.tvl1_outer_loop(*args, epsilon=eps, **kw)
        t0 = time.perf_counter()
        ref = tk.tvl1_outer_loop_plain(*args, epsilon=eps, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs(got, ref)
        log(f"K1 tvl1_outer_loop ({b},{h},{w}) true-flow inputs eps={eps}: "
            f"max|kernel - plain| = {err} (tolerance {tol}"
            f"{': bit-equal' if tol == 0 else ': a pair may stop one step apart on an ulp of its error sum'})")
        assert err <= tol, (eps, err)
        ms = cuda_ms(lambda: tk.tvl1_outer_loop(*args, epsilon=eps, **kw), 3)
        if eps > 0:
            steps, medians = k1_active_work(args, epsilon=eps, **kw)
            ops_px = (steps * (OPS_STEP + OPS_ERR)
                      + medians * 2 * OPS_MEDIAN_PLANE) * h * w
        else:
            steps, medians = b * 300, b * 10
            ops_px = b * (300 * OPS_STEP + 10 * 2 * OPS_MEDIAN_PLANE) * h * w
        bms, by = bound(16 * 4 * npx, ops_px)
        own = (steps * K1_STEP_BYTES + medians * MEDIAN_BYTES) * h * w
        log(f"K1 true-flow eps={eps}: {steps} of {b * 300} pair-steps and "
            f"{medians} of {b * 10} pair-medians ran; {ms:.3f} ms kernel, "
            f"{plain_ms:.3f} ms plain, bound {bms:.4f} ms ({by}); own "
            f"traffic at {own / ms / 1e9:.3f} TB/s")
        k1[eps] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bms, bound_by=by)
    records["tvl1_outer_loop"] = dict(k1[0.01], eps0=k1[0.0])

    return records


@contextlib.contextmanager
def record_k3(captured, calls):
    """Wrap the K3 wrapper that deepflow_pairs calls: count its calls per
    level shape in ``calls`` and keep, in ``captured``, a copy of the
    arguments and keywords of the first call at each shape of K3_SHAPES;
    restore it on exit. The wrapper counts its launches on its own module
    attribute, so the recorder shares the wrapper's attributes."""
    from tee_optical_flow_torch.ops import deepflow_kernels as dk

    inner = dk.sor_sweeps

    def recording(*args, **kw):
        shape = tuple(args[0].shape[1:])
        calls[shape] = calls.get(shape, 0) + 1
        if shape in K3_SHAPES and shape not in captured:
            captured[shape] = ([None if a is None else
                                tuple(t.clone() for t in a)
                                if isinstance(a, tuple) else a.clone()
                                for a in args], dict(kw))
        return inner(*args, **kw)

    dk.sor_sweeps = recording
    try:
        yield
    finally:
        dk.sor_sweeps = inner


def phase_k3(captured, calls):
    """K3 against its plain version, bit-equal, on the arguments the
    DeepFlow path gave it at each of its five levels (39 pairs at 480x640
    down to 30x40; the two coarsest with the matching term). Times each
    with CUDA events and counts its device launches per call."""
    import torch

    from tee_optical_flow_torch.ops import deepflow_kernels as dk
    from tee_optical_flow_torch.ops.cuda_lib import load_library

    log(f"K3 calls per level shape in the first DeepFlow run: "
        f"{ {f'{h}x{w}': c for (h, w), c in calls.items()} }")
    assert len(calls) == DF_LEVELS, calls
    assert all(c == DF_FP_ITERS for c in calls.values()), calls
    assert set(captured) == set(K3_SHAPES), (list(captured), K3_SHAPES)
    out = {}
    for shape in K3_SHAPES:
        args, kw = captured[shape]
        planes, match = args[:10], args[10] if len(args) > 10 else None
        b, h, w = planes[0].shape
        npx = b * h * w
        got = dk.sor_sweeps(*planes, match, **kw)
        ref = dk.sor_sweeps_plain(*planes, match, **kw)
        err = max_abs(got, ref)
        tag = f"K3 sor_sweeps ({b},{h},{w}) {'match' if match else 'no match'}"
        log(f"{tag}: max|kernel - plain| = {err} (tolerance 0: bit-equal), "
            f"max|du| {float(got[0].abs().max()):.4f} px")
        assert err == 0.0, (tag, err)
        assert all(bool(torch.isfinite(t).all()) for t in got)
        ms = cuda_ms(lambda: dk.sor_sweeps(*planes, match, **kw), 10)
        plain_ms = cuda_ms(lambda: dk.sor_sweeps_plain(*planes, match, **kw),
                           2)
        resident = dk.resident(load_library(), h, w)
        want = k3_device_launches(resident, kw["psi_iters"], kw["sor_iters"])
        dev = device_launches(lambda: dk.sor_sweeps(*planes, match, **kw),
                              DEEPFLOW_DEVICE_KERNELS)
        assert dev == want, (tag, dev, want)
        n_in = len(planes) + (3 if match else 0)
        ops_px = kw["psi_iters"] * (
            OPS_DF_WEIGHTS + OPS_DF_COEFS + (OPS_DF_MATCH if match else 0)
            + kw["sor_iters"] * OPS_DF_SOR)
        bms, by = bound((n_in + 2) * 4 * npx, ops_px * npx)
        own = k3_own_bytes(b, h, w, bool(match), kw["psi_iters"],
                           kw["sor_iters"], resident)
        log(f"{tag}: {ms:.4f} ms kernel, {plain_ms:.3f} ms plain, bound "
            f"{bms:.4f} ms ({by}), {dev} device launches per call "
            f"({'resident' if resident else 'tiled'}); own "
            f"traffic ({own / npx:.1f} B per pixel) at "
            f"{own / ms / 1e9:.3f} TB/s")
        out[f"{h}x{w}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bms, bound_by=by,
                               shape=[b, h, w], match=bool(match),
                               path_calls=calls[shape],
                               device_launches=dev)
    return out


@contextlib.contextmanager
def record_tvl1(name, shapes, captured, calls, every=False):
    """Wrap the TV-L1 loop wrapper ``name`` that _tvl1_scale calls (K1's
    tvl1_outer_loop or the block loop), as record_k3 wraps K3: count its
    calls per level shape in ``calls`` and keep, in ``captured``, a copy
    of the arguments and keywords of the first call at each of ``shapes``
    (with ``every``, a list of every call's); restore it on exit."""
    from tee_optical_flow_torch.ops import tvl1 as tt
    from tee_optical_flow_torch.ops import tvl1_kernels as tk

    inner = getattr(tk, name)

    def recording(*args, **kw):
        shape = tuple(args[0].shape[1:])
        calls[shape] = calls.get(shape, 0) + 1
        if shape in shapes:
            call = ([a.clone() for a in args], dict(kw))
            if every:
                captured.setdefault(shape, []).append(call)
            elif shape not in captured:
                captured[shape] = call
        return inner(*args, **kw)

    setattr(tk, name, recording)
    setattr(tt, name, recording)
    try:
        yield
    finally:
        setattr(tk, name, inner)
        setattr(tt, name, inner)


def device_launches(fn, names, lib=None) -> int:
    """Device launches that one call of fn() issues from the kernel library
    (``lib``, the default one unless given), read from the library's own
    count (cuda_lib.device_launch_count: each C entry counts a launch once
    the launch call returned cudaSuccess). The profiler stays as a
    cross-check: a trace of a second call may show fewer of ``names``'
    kernels (it may lose events: one showed none of K1's single launch,
    others 59 of the block loop's 60) but never more, and the second call
    must count the same."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tee_optical_flow_torch.ops.cuda_lib import device_launch_count

    counts = []
    for traced in (False, True):
        torch.cuda.synchronize()
        device_launch_count(lib, reset=True)
        with (profile(activities=[ProfilerActivity.CUDA]) if traced
              else contextlib.nullcontext()) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(device_launch_count(lib, reset=True))
    assert counts[0] == counts[1], counts
    seen = sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and any(is_kernel(e.name, n) for n in names))
    assert seen <= counts[0], (seen, counts[0])
    return counts[0]


def phase_k1(captured, calls):
    """K1 against its plain version on the arguments the TV-L1 path gave it
    at its finest (39x480x640) and coarsest (39x197x262) level: bit-equal
    at epsilon 0, within 0.05 px at the path's epsilon 0.01. Times each
    with CUDA events and counts its device launches per call."""
    import torch

    from tee_optical_flow_torch.ops import tvl1_kernels as tk

    log(f"K1 calls per level shape in the first TV-L1 run: "
        f"{ {f'{h}x{w}': c for (h, w), c in calls.items()} }")
    assert len(calls) == TV_LEVELS, calls
    assert all(c == TV_WARPS for c in calls.values()), calls
    assert set(captured) == set(K1_SHAPES), (list(captured), K1_SHAPES)
    out = {}
    for shape in K1_SHAPES:
        args, kw = captured[shape]
        assert kw["epsilon"] == 0.01 and kw["use_median"], kw
        b, h, w = args[0].shape
        npx = b * h * w
        for eps, tol in ((0.01, 0.05), (0.0, 0.0)):
            kwe = dict(kw, epsilon=eps)
            tag = f"K1 tvl1_outer_loop ({b},{h},{w}) path args eps={eps}"
            got = tk.tvl1_outer_loop(*args, **kwe)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = tk.tvl1_outer_loop_plain(*args, **kwe)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = max_abs(got, ref)
            log(f"{tag}: max|kernel - plain| = {err} (tolerance {tol}"
                f"{': bit-equal' if tol == 0 else ': a pair may stop one step apart on an ulp of its error sum'})")
            assert err <= tol, (tag, err)
            assert all(bool(torch.isfinite(t).all()) for t in got)
            ms = cuda_ms(lambda: tk.tvl1_outer_loop(*args, **kwe), 5)
            dev = device_launches(lambda: tk.tvl1_outer_loop(*args, **kwe),
                                  TVL1_DEVICE_KERNELS)
            assert dev == 1, (tag, dev)
            outer, inner = kw["outer_iters"], kw["inner_iters"]
            if eps > 0:
                steps, medians = k1_active_work(args, **kwe)
            else:
                steps, medians = b * outer * inner, b * outer
            ops_px = (steps * (OPS_STEP + (OPS_ERR if eps > 0 else 0))
                      + medians * 2 * OPS_MEDIAN_PLANE) * h * w
            bms, by = bound(16 * 4 * npx, ops_px)
            own = (steps * K1_STEP_BYTES + medians * MEDIAN_BYTES) * h * w
            log(f"{tag}: {steps} of {b * outer * inner} pair-steps and "
                f"{medians} of {b * outer} pair-medians ran; {ms:.3f} ms "
                f"kernel, {plain_ms:.3f} ms plain, bound {bms:.4f} ms ({by}), "
                f"{dev} device launches per call; own traffic "
                f"({K1_STEP_BYTES} B per pixel and step, {MEDIAN_BYTES} per "
                f"median) at {own / ms / 1e9:.3f} TB/s")
            out[(shape, eps)] = dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms, bound_ms=bms,
                                     bound_by=by, shape=[b, h, w],
                                     pair_steps=steps, pair_medians=medians,
                                     device_launches=dev)
    # the grid barrier's cost: one 16x32 pair (one tile) at epsilon 0 is
    # nothing but phases; an upper bound, as the wrapper's own small
    # launches between calls are in the time
    args, kw = captured[K1_SHAPES[0]]
    one = [a[:1, :16, :32].contiguous() for a in args]
    kw0 = dict(kw, epsilon=0.0)
    phases = kw["outer_iters"] * (kw["inner_iters"] + 1)
    ms = cuda_ms(lambda: tk.tvl1_outer_loop(*one, **kw0), 10)
    log(f"K1 on one 16x32 pair at eps 0 ({phases} phases, one tile each): "
        f"{ms:.3f} ms, {1e3 * ms / phases:.2f} us per phase and grid "
        f"barrier")
    out["barrier_us"] = 1e3 * ms / phases
    return out


_COUNTS_BASE = {}
_WRAPPERS = ("tvl1_outer_loop", "tvl1_block_loop", "tvl1_inner_block",
             "median_filter_5x5", "sor_sweeps", "connected_components",
             "rel_pos_attention")


def reset_counts():
    """Every wrapper's launch count (its ``launches.<wrapper>`` counter,
    read from here on as a difference from now), and the kernel library's
    own count of device launches (cuda_lib.device_launch_count), to 0."""
    from tee_optical_flow_torch.ops.cuda_lib import device_launch_count
    from tee_optical_flow_torch.utils.tracing import get_counters

    device_launch_count(reset=True)
    _COUNTS_BASE.clear()
    _COUNTS_BASE.update(get_counters())


def read_counts():
    """Each wrapper's launches since the last ``reset_counts``."""
    from tee_optical_flow_torch.utils.tracing import get_counters

    now = get_counters()
    return {name: now.get(f"launches.{name}", 0)
            - _COUNTS_BASE.get(f"launches.{name}", 0) for name in _WRAPPERS}


def label_launches():
    """The labelling's pass launches since the last ``reset_counts`` (its
    ``labelling_passes`` counter: whole groups of passes up to each
    labelling's first quiet pass, as labelling_schedule plans them)."""
    from tee_optical_flow_torch.utils.tracing import get_counters

    return (get_counters().get("labelling_passes", 0)
            - _COUNTS_BASE.get("labelling_passes", 0))


def check_schema(saved, n, h, w, mode="otsu"):
    """The HDF5 schema on what process_video wrote (or handed to its save
    function): shapes, dtypes, mask names, the duplicated last flow
    frame, finite flow, the attributes."""
    from tee_optical_flow_torch.flow.segment import LABEL_MAPS

    flow, echo, masks = saved["flow"], saved["echo"], saved["masks"]
    attrs = saved["attrs"]
    assert flow.shape == (n, h, w, 2) and flow.dtype == np.float16, \
        (flow.shape, flow.dtype)
    assert echo.shape == (n, h, w) and echo.dtype == np.float16
    names = ["otsu"] if mode == "otsu" else list(LABEL_MAPS[mode]) + ["bkgd"]
    assert list(masks) == names, list(masks)
    for name in names:
        assert masks[name].shape == (n, h, w, 2), (name, masks[name].shape)
        assert masks[name].dtype == bool, (name, masks[name].dtype)
    if mode == "otsu":
        assert masks["otsu"].any() and not masks["otsu"].all()
    np.testing.assert_array_equal(flow[-1], flow[-2])  # duplicated last
    assert np.isfinite(flow.astype(np.float32)).all()
    assert attrs["nframes"] == n and attrs["mode"] == mode
    assert abs(attrs["frame_rate"] - FPS) < 1e-9
    assert abs(attrs["pixel_spacing"] - SPACING_CM) < 1e-12


def check_outputs(saved, n, h, w, truth, bounds, mode="otsu"):
    """check_schema, and the flow against the analytic motion on the
    wall, within bounds = (median, p95) px."""
    check_schema(saved, n, h, w, mode)
    flow = saved["flow"]
    wall_epe(flow[:-1].astype(np.float32) / (SPACING_CM * FPS), truth,
             bounds)


def wall_epe(px, truth, bounds):
    """The (P, H, W, 2) flow in px against the analytic motion on the
    wall: median and p95 end-point error within bounds = (median, p95)
    px."""
    from tee_optical_flow_torch.synthetic import echo_sector_masks

    h, w = px.shape[1:3]
    wall = echo_sector_masks(h, w)["wall"].copy()
    wall[:8] = wall[-8:] = False
    wall[:, :8] = wall[:, -8:] = False
    epe = np.hypot(px[..., 0] - truth[..., 0], px[..., 1] - truth[..., 1])
    epe = epe[:, wall]
    med, p95 = float(np.median(epe)), float(np.percentile(epe, 95))
    motion = float(np.median(np.hypot(truth[..., 0], truth[..., 1])[:, wall]))
    log(f"flow vs analytic motion on the wall ({epe.size} px-pairs, median "
        f"true motion {motion:.3f} px): EPE median {med:.4f} px (bound "
        f"{bounds[0]}), p95 {p95:.4f} px (bound {bounds[1]})")
    assert med < bounds[0] and p95 < bounds[1], (med, p95)
    return med, p95


def profile_clip(run_clip):
    """One more clip under torch.profiler: the device's busy share of the
    clip's wall time (kernel time over wall, one stream) and the kernels
    that take it, with each kernel source's sum. The profiler's own cost
    inflates the wall time. Returns, for each kernel source, the launches
    and device ms of each of its kernels in the clip: a lower bound, as a
    trace may lose events (one of a 600x800 clip's, device activity only,
    held 308 of its 370 csrc/tvl1.cu launches). Device activity only: the
    host's events are not read, and collecting them took 30-40 s a clip."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_clip()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    log(f"profiled clip: wall {wall:.3f} s, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}%), {len(kernels)} device events")
    by_name = {}
    for e in kernels:
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + e.time_range.elapsed_us() / 1e3)
    for name, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        log(f"  {t:9.2f} ms {c:7d}x {name[:90]}")
    sources = {}
    for source, names in DEVICE_KERNELS.items():
        ours = {}
        for name, (c, t) in by_name.items():
            for n in names:
                if is_kernel(name, n):
                    c0, t0 = ours.get(n, (0, 0.0))
                    ours[n] = (c0 + c, t0 + t)
        if ours:
            log(f"  csrc/{source}'s kernels in the clip: "
                f"{sum(t for _, t in ours.values()):.2f} ms over "
                f"{sum(c for c, _ in ours.values())} launches ("
                + ", ".join(f"{n} {t:.2f} ms {c}x"
                            for n, (c, t) in ours.items()) + ")")
        sources[source] = ours
    return sources


# per path through process_video: its mask mode and flow algorithm, the
# launches each clip must count, the only csrc/tvl1.cu kernels its
# profiled clip may show, and the wall EPE bounds. TV-L1 at 480x640: 5
# levels x 5 warps of K1, each one device launch with the medians inside.
# DeepFlow: 5 levels x 3 fixed points of K3. TV-L1 at 600x800: the finest
# level's 5 warps take the block loop (median fused in), the 4 coarser
# levels K1; the 480x640 TV-L1 bounds hold there too (the reading is
# printed). SAM: the segmentor's masks, then the 480x640 TV-L1 flow.
# device_launches: the kernel library's own count over the clip
# (cuda_lib.device_launch_count): K1 1 per call; K3 12 per call at the
# three tiled levels and 1 at the two resident ones (3 psi rounds of 12
# SOR iterations); the block loop 70 per call at epsilon 0.01; on top, the
# masks' labellings (connected_components calls), each whole groups of
# pass launches up to its first quiet pass (labelling_schedule of a plain
# count of the rounds each recorded mask needs):
# two a clip on the Otsu paths (fill and size filter), two per label on the
# RVIO_2class paths (rv, av)
_NONE = {"tvl1_outer_loop": 0, "tvl1_block_loop": 0, "tvl1_inner_block": 0,
         "median_filter_5x5": 0, "sor_sweeps": 0, "connected_components": 0,
         "rel_pos_attention": 0}
OTSU_LABELLINGS, RVIO_LABELLINGS = 2, 4
PATHS = {
    "TVL1": dict(mode="otsu", algo="TVL1",
                 counts=dict(_NONE, tvl1_outer_loop=TV_LEVELS * TV_WARPS,
                             connected_components=OTSU_LABELLINGS),
                 device={"outer_loop_kernel"},
                 device_launches=TV_LEVELS * TV_WARPS,
                 bounds=(WALL_MEDIAN_EPE_PX, WALL_P95_EPE_PX)),
    "deepflow": dict(mode="otsu", algo="deepflow",
                     counts=dict(_NONE, sor_sweeps=DF_LEVELS * DF_FP_ITERS,
                                 connected_components=OTSU_LABELLINGS),
                     device=set(),
                     device_launches=DF_FP_ITERS * (
                         3 * k3_device_launches(False, 3, 12)
                         + 2 * k3_device_launches(True, 3, 12)),
                     bounds=(DF_WALL_MEDIAN_EPE_PX, DF_WALL_P95_EPE_PX)),
    "TVL1 600x800": dict(
        mode="otsu", algo="TVL1",
        counts=dict(_NONE, tvl1_outer_loop=(TV_LEVELS - 1) * TV_WARPS,
                    tvl1_block_loop=TV_WARPS,
                    connected_components=OTSU_LABELLINGS),
        device={"outer_loop_kernel", "block_sweep_kernel",
                "block_end_kernel"},
        device_launches=(TV_LEVELS - 1) * TV_WARPS + TV_WARPS * 10 * (6 + 1),
        bounds=(WALL_MEDIAN_EPE_PX, WALL_P95_EPE_PX)),
    "SAM": dict(mode="RVIO_2class", algo="TVL1",
                counts=dict(_NONE, tvl1_outer_loop=TV_LEVELS * TV_WARPS,
                            connected_components=RVIO_LABELLINGS),
                device={"outer_loop_kernel"},
                device_launches=TV_LEVELS * TV_WARPS,
                bounds=(WALL_MEDIAN_EPE_PX, WALL_P95_EPE_PX)),
}


def phase_path(name, dcm, clip, truth, has_h5py, workdir,
               first_run=contextlib.nullcontext, segmentor=None):
    """One path of PATHS through process_video, twice (the first inside
    ``first_run()``); the counts of each run, the outputs' checks, a
    profiled clip and the solver alone. A segmentor mode runs
    ``segmentor``. Returns the second run's counts, its clip seconds, the
    solver's seconds, the profiled clip's kernels and what was saved."""
    import torch

    from tee_optical_flow_torch.config import default_optical_flow_config
    from tee_optical_flow_torch.flow.pipeline import (
        compute_clip_flow, process_video,
    )
    from tee_optical_flow_torch.io.dicom import read_dicom_clip
    from tee_optical_flow_torch.ops.cuda_lib import device_launch_count
    from tee_optical_flow_torch.ops.imaging import gray_from_clip, img2uint8
    from tee_optical_flow_torch.utils import get_stage_report

    n, h, w = clip.shape
    path = PATHS[name]
    algo, mode = path["algo"], path["mode"]
    log(f"--- path: process_video(mode={mode!r}, OF_algo={algo!r}, "
        f"no_saliency=True) on {n}x{h}x{w}")
    out = os.path.join(workdir, f"echo_synthetic_{mode}_{algo}_{h}x{w}.hdf5")
    cfg = default_optical_flow_config()
    saved = {}

    def capture(save_path, flow_arr, echo_gray, mask_dict, metadata,
                waveforms, **kw):
        saved.update(flow=flow_arr, echo=echo_gray, masks=mask_dict,
                     attrs={"nframes": metadata["nframes"], "mode": kw["mode"],
                            "frame_rate": metadata["frame_rate"],
                            "pixel_spacing": metadata["pixel_spacing"]})

    kw = dict(verbose=False, mode=mode, OF_algo=algo, no_saliency=True,
              config=cfg)
    if not has_h5py:
        kw["_save_fn"] = capture
        log("h5py is absent: the schema is checked on the arrays handed to "
            "process_video's save function")
    labellings = path["counts"]["connected_components"]
    clip_s, counts = [], []
    for run in range(2):
        get_stage_report(reset=True)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with first_run() if run == 0 else contextlib.nullcontext(), \
                recording_labellings() as calls:
            process_video(dcm, out, segmentor, **kw)
        torch.cuda.synchronize()
        clip_s.append(time.perf_counter() - t0)
        counts.append(read_counts())
        dev = device_launch_count()
        assert len(calls) == labellings, (name, len(calls))
        design = path["device_launches"] + planned_label_launches(calls)
        log(f"process_video: {clip_s[-1]:.3f} s, launches {counts[-1]}, "
            f"{dev} device launches (the library's count; design "
            f"{design}, {labellings} labellings among them)")
        assert dev == design, (name, dev)
        log("  stages (host clock, s): " + ", ".join(
            f"{k} {v['total_s']:.3f}" for k, v in get_stage_report().items()))
    for c in counts:
        assert c == path["counts"], (name, c)
    if has_h5py:
        import h5py

        with h5py.File(out, "r") as f:
            saved = dict(flow=f["flow"][()], echo=f["echo"][()],
                         masks={k: f[k][()] for k in f["flow"].attrs["labels"]},
                         attrs={k: f["flow"].attrs[k] for k in
                                ("nframes", "mode", "frame_rate",
                                 "pixel_spacing")})
            assert sorted(f.keys()) == sorted(["RWaveTime", "echo", "flow",
                                               *saved["masks"]])
    check_outputs(saved, n, h, w, truth, path["bounds"], mode)
    device = profile_clip(lambda: process_video(dcm, out, segmentor, **kw))
    assert set(device["tvl1.cu"]) <= path["device"], (name, device)
    traced = sum(c for ours in device.values() for c, _ in ours.values())
    assert traced <= design, (name, traced)

    # the solver alone, on the same flow inputs, timed to completion
    _, arr = read_dicom_clip(dcm)
    frames = np.concatenate([arr, np.repeat(arr[-1:], 7, axis=0)])[..., 0]
    images = img2uint8(gray_from_clip(torch.from_numpy(
        np.ascontiguousarray(frames)).cuda()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compute_clip_flow(images, algo, cfg)
    torch.cuda.synchronize()
    solver_s = time.perf_counter() - t0
    log(f"{name} steady-state clip: {clip_s[1]:.3f} s (first run "
        f"{clip_s[0]:.3f} s); solver alone: {solver_s:.3f} s for "
        f"{images.shape[0] - 1} pairs at {h}x{w}")
    return counts[1], clip_s[1], solver_s, device, saved


def rounds_needed(mask, connectivity):
    """Rounds of neighbour-min propagation after which no id of the (N,
    H, W) mask changes any more, counted round by round with plain
    PyTorch operations on the mask's device."""
    import torch

    from tee_optical_flow_torch.ops import morphology as mo

    _, h, w = mask.shape
    big = h * w
    ids = torch.where(mask, torch.arange(big, dtype=torch.int32,
                                         device=mask.device).reshape(1, h, w),
                      big)
    rounds = 0
    while True:
        nxt = torch.where(mask, mo._neighbor_min(ids, big, connectivity), big)
        if torch.equal(nxt, ids):
            return rounds
        ids, rounds = nxt, rounds + 1


def labelling_schedule(needed, h, w, rounds_per_pass=None):
    """What one labelling of H x W frames runs where the last round that
    changes an id is round ``needed`` (``rounds_needed``): (rounds run,
    flag reads on a card, pass launches on a card). The rounds are every
    pass's up to and with the first quiet one, at most H*W; a card
    launches whole groups of ops/morphology.LABEL_PASSES_PER_READ passes
    (the cap's remainder last) and reads their flags once a group.
    ``rounds_per_pass`` is LABEL_ROUNDS_PER_PASS unless given."""
    from tee_optical_flow_torch.ops import morphology as mo

    r = rounds_per_pass or mo.LABEL_ROUNDS_PER_PASS
    k = mo.LABEL_PASSES_PER_READ
    total = -(-h * w // r)
    passes = min(-(-needed // r) + 1, total)
    reads = -(-passes // k)
    return min(passes * r, h * w), reads, min(reads * k, total)


@contextlib.contextmanager
def recording_labellings():
    """Within it, every ops/morphology.connected_components call keeps its
    (N, H, W) mask and connectivity in the list it yields."""
    import torch

    from tee_optical_flow_torch.ops import morphology as mo

    calls = []
    inner = mo.connected_components

    def recording(mask, connectivity=2):
        m = mask.to(torch.bool).clone()
        calls.append((m[None] if m.ndim == 2 else m, connectivity))
        return inner(mask, connectivity)

    with substituted(mo, "connected_components", recording):
        yield calls


def planned_label_launches(calls):
    """The pass launches ``labelling_schedule`` plans for recorded
    labellings, each from a plain count of the rounds its mask needs."""
    return sum(labelling_schedule(rounds_needed(m, c), *m.shape[1:])[2]
               for m, c in calls)


def label_stack(n, h, w):
    """The complement of the Otsu masks of an n-frame h x w echo stack (the
    33-frame clip, its last frame repeated as the clip path buckets it) on
    the card: what binary_fill_holes labels, 4-connected."""
    import torch

    from tee_optical_flow_torch.ops.otsu import otsu_mask_stack

    frames, _ = echo_clip(CLIP_FRAMES, h, w)
    frames = np.concatenate([frames, np.repeat(frames[-1:], n - CLIP_FRAMES,
                                               axis=0)])
    gray = torch.from_numpy(frames).cuda().to(torch.float32) / 255.0
    return ~otsu_mask_stack(gray)


def phase_labelling():
    """The labelling kernel (csrc/labelling.cu) at both clip cells' shapes
    on label_stack's masks, connectivity 1: bit-equal to the plain loop on
    the card, its mean ms over 5 calls (CUDA events), its bound (the
    larger of the mask read and the ids written at the HBM rate and 5
    integer operations a pixel-round at the float32 rate), its device
    launches per call (the library's count: whole groups of passes up to
    the first quiet one, labelling_schedule) and the plain
    loop's ms (one call, host clock, synchronised)."""
    import torch

    from tee_optical_flow_torch.ops import morphology as mo

    records = {}
    for n, h, w in LABEL_SHAPES:
        mask = label_stack(n, h, w)
        got = mo.connected_components(mask, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = mo.connected_components_plain(mask, 1)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        equal = bool(torch.equal(got, ref))
        assert equal, (n, h, w)
        ms = cuda_ms(lambda: mo.connected_components(mask, 1), 5)
        dev = device_launches(lambda: mo.connected_components(mask, 1),
                              LABEL_DEVICE_KERNELS)
        rounds, _, launches = labelling_schedule(rounds_needed(mask, 1),
                                                 h, w)
        assert dev == launches, dev
        npx = n * h * w
        bms, by = bound(LABEL_BYTES * npx, OPS_LABEL_ROUND * npx * rounds)
        rate = npx * rounds / ms / 1e6
        log(f"labelling ({n},{h},{w}) connectivity 1, {rounds} rounds: "
            f"bit-equal to the plain loop; {ms:.3f} ms kernel, "
            f"{plain_ms:.3f} ms plain, bound {bms:.4f} ms ({by}), {dev} "
            f"device launches, {rate:.1f} G pixel-rounds/s")
        records[f"{n}x{h}x{w}"] = dict(
            max_abs_err=0 if equal else None, ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, device_launches=dev)
    return records


def labelling_check() -> int:
    """phase_labelling alone, after the kernels' build: prints its record
    as one JSON line. Run on the card with python3 -c "import chip_smoke,
    sys; sys.exit(chip_smoke.labelling_check())"."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    phase_setup()
    print(json.dumps({"labelling": phase_labelling()}))
    return 0


def labelling_tuning():
    """The labelling kernel under each build of LB_VARIANTS on
    label_stack's masks at both clip shapes, connectivity 1 and 2: mean
    ms over 3 calls (CUDA events), device launches per call and equality
    with the default build. The basis of csrc/labelling.cu's LB_R and
    extended tile. The host plans its passes by the default R
    (ops/morphology.LABEL_ROUNDS_PER_PASS): a build with another LB_R runs
    its own rounds a pass and stops at its first quiet pass all the same,
    so its labels hold, and the rounds it reports do not. Run on the card
    with python3 -c "import chip_smoke; chip_smoke.labelling_tuning()"."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from tee_optical_flow_torch.ops import cuda_lib
    from tee_optical_flow_torch.ops import morphology as mo

    log(f"card: {phase_setup()[0]}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        libs = list(pool.map(cuda_lib.load_library, LB_VARIANTS))
    log(f"{len(libs)} builds of the kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    for n, h, w in LABEL_SHAPES:
        mask = label_stack(n, h, w).contiguous()
        for connectivity in (1, 2):
            ref = mo.connected_components(mask, connectivity)
            for defines, lib in zip(LB_VARIANTS, libs):
                def run():
                    return mo._label_on_card(mask, connectivity, lib)[0]

                equal = bool(torch.equal(run(), ref))
                ms = cuda_ms(run, 3)
                dev = device_launches(run, LABEL_DEVICE_KERNELS, lib)
                log(f"labelling tuning ({n},{h},{w}) connectivity "
                    f"{connectivity} {defines or 'production'}: {ms:.3f} ms,"
                    f" {dev} device launches, equal to the default build: "
                    f"{equal}")
                assert equal, defines


def attention_module(heads, hd, h, w, dtype, device, seed=0):
    """A RelPosAttention on an h x w grid with its weights drawn as the SAM
    cell draws a checkpoint: dense weights at 1/sqrt(fan-in), biases at
    ATTN_BIAS_SPREAD, tables at REL_POS_SPREAD / sqrt(hd)."""
    import math

    import torch

    from tee_optical_flow_torch.models.image_encoder import RelPosAttention

    gen = torch.Generator().manual_seed(seed)
    m = RelPosAttention(heads * hd, heads, input_size=(h, w), dtype=dtype)
    with torch.no_grad():
        for lin in (m.qkv, m.proj):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen)
                             / math.sqrt(lin.weight.shape[1]))
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=gen)
                           * ATTN_BIAS_SPREAD)
        for t in (m.rel_pos_h, m.rel_pos_w):
            t.copy_(torch.randn(t.shape, generator=gen)
                    * REL_POS_SPREAD / math.sqrt(hd))
    return m.to(device)


def attention_qkv(m, b, h, w, seed=1):
    """The module's qkv projection of (b, h, w, dim) standard normal tokens
    (what the block's LayerNorm hands it), reshaped as its forward does:
    (b, N, 3, heads, hd)."""
    import torch

    from tee_optical_flow_torch.models.common import linear

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, h, w, m.num_heads * m.head_dim), generator=gen)
    return linear(x.to(m.qkv.weight.device), m.qkv, m.dtype).reshape(
        b, h * w, 3, m.num_heads, m.head_dim)


def attention_bound(b, heads, h, w, hd):
    """(least ms, what bounds it) of one kernel launch: its own work, the
    scores and the weighted sum (4 B heads N^2 hd operations) at the dense
    bfloat16 peak against what it reads and writes at the HBM rate (q, k,
    v and the output in bfloat16, the two float32 bias projections)."""
    n = h * w
    ops = 4 * b * heads * n * n * hd
    nbytes = 4 * b * n * heads * hd * 2 + b * heads * n * (h + w) * 4
    t_ops = ops / ATTN_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def attention_span_bound(b, heads, h, w, hd):
    """Least ms of what the global_attn span wraps at the shape, counts_sam
    .global_attn_least_s's count: the kernel's work and the bias
    projections' operations (2 B heads N (h + w) hd) at the dense
    bfloat16 peak against q, k, v and the output in bfloat16 and the two
    tables in float32 at the HBM rate."""
    n = h * w
    ops = 4 * b * heads * n * n * hd + 2 * b * heads * n * (h + w) * hd
    nbytes = 4 * b * n * heads * hd * 2 + (2 * h - 1 + 2 * w - 1) * hd * 4
    return max(ops / ATTN_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3


def attention_args(m, qkv, h, w):
    """The kernel wrapper's arguments for the module's qkv: the bias
    projections computed as the module computes them for the kernel."""
    return (qkv, *m._bias_terms(qkv[:, :, 0], h, w), h, w,
            m.head_dim ** -0.5)


def attention_float32(m, qkv, h, w):
    """The attention of the module's bfloat16 qkv (B, N, 3, heads, hd) in
    float32 with no rounding, (B, N, heads, hd): the bias from the JAX
    package's einsums over the float32 queries and tables (not from the
    module's ``_bias_terms``, which feeds the kernel), the scores, softmax
    and weighted sum in float32."""
    import torch

    from tee_optical_flow_torch.models.image_encoder import rel_pos_embed

    q, k, v = (t.to(torch.float32) for t in qkv.permute(2, 0, 3, 1, 4))
    b, heads, n, hd = q.shape
    qr = q.reshape(b, heads, h, w, hd)
    bias_h = torch.einsum("byhwc,hkc->byhwk", qr,
                          rel_pos_embed(m.rel_pos_h, h, h))
    bias_w = torch.einsum("byhwc,wkc->byhwk", qr,
                          rel_pos_embed(m.rel_pos_w, w, w))
    s = torch.matmul(q, k.transpose(-2, -1)) * (hd ** -0.5)
    s += (bias_h[..., :, None] + bias_w[..., None, :]).reshape(b, heads, n, n)
    return torch.matmul(torch.softmax(s, dim=-1), v).transpose(1, 2)


def phase_attention():
    """The attention kernel (csrc/relpos_attention.cu) at ATTN_SHAPES:
    its error and the plain version's (``_attend``) against a float32
    attention of the same bfloat16 q, k, v with the bias from the einsums
    (attention_float32; max and mean abs, the kernel's at most 1.25 times
    the plain version's), its mean ms (CUDA events) alone against its own
    bound (attention_bound: ``roofline``) and with the bias projections
    (what the global_attn span wraps: ``module_ms`` against
    attention_span_bound, ``span_roofline``), the plain version's ms,
    torch's scaled_dot_product_attention with the bias materialised in
    bfloat16 as the yardstick (library_ms; the port never calls it), and
    the device launches a call (the library's count)."""
    import torch
    import torch.nn.functional as F

    from tee_optical_flow_torch.ops import attention_kernels as ak
    from tee_optical_flow_torch.ops.cuda_lib import device_launch_count

    records = {}
    for name, (b, heads, h, w, hd) in ATTN_SHAPES.items():
        m = attention_module(heads, hd, h, w, torch.bfloat16, "cuda")
        n = h * w
        with torch.no_grad():
            qkv = attention_qkv(m, b, h, w)
            args = attention_args(m, qkv, h, w)
            q, k, v = qkv.permute(2, 0, 3, 1, 4)
            ref = attention_float32(m, qkv, h, w).to(torch.float64)
            got = ak.rel_pos_attention(*args).to(torch.float64)
            plain = m._attend(q, k, v, h, w).transpose(1, 2).to(
                torch.bfloat16).to(torch.float64)
            err, plain_err = (got - ref).abs(), (plain - ref).abs()
            errors = dict(max_abs_err=float(err.max()),
                          mean_abs_err=float(err.mean()),
                          plain_max_abs_err=float(plain_err.max()),
                          plain_mean_abs_err=float(plain_err.mean()))
            del got, plain, ref, err, plain_err
            reps = 20 if n >= 4096 else 50
            ms = cuda_ms(lambda: ak.rel_pos_attention(*args), reps)
            module_ms = cuda_ms(lambda: m._attend_kernel(qkv, h, w), reps)
            plain_ms = cuda_ms(lambda: m._attend(q, k, v, h, w), 3)
            mask = (args[1][..., :, None] + args[2][..., None, :]).reshape(
                b, heads, n, n).to(torch.bfloat16)
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), reps)
            del mask
            device_launch_count(reset=True)
            ak.rel_pos_attention(*args)
            torch.cuda.synchronize()
            dev = device_launch_count()
        bms, by = attention_bound(b, heads, h, w, hd)
        span_bms = attention_span_bound(b, heads, h, w, hd)
        log(f"rel_pos_attention {name} (B {b}, heads {heads}, {h}x{w}, hd "
            f"{hd}): {ms:.4f} ms kernel ({100 * bms / ms:.1f}% of its bound"
            f" {bms:.4f} ms, {by}), {module_ms:.4f} ms with the bias "
            f"projections ({100 * span_bms / module_ms:.1f}% of the span's "
            f"{span_bms:.4f} ms), {plain_ms:.3f} ms plain, {library_ms:.4f} "
            f"ms SDPA with the bias materialised; error against float32 "
            f"{errors['max_abs_err']:.3g} max, {errors['mean_abs_err']:.3g}"
            f" mean (plain {errors['plain_max_abs_err']:.3g}, "
            f"{errors['plain_mean_abs_err']:.3g}); {dev} device launch(es)")
        assert errors["max_abs_err"] <= 1.25 * errors["plain_max_abs_err"], \
            (name, errors)
        assert errors["mean_abs_err"] <= 1.25 * errors[
            "plain_mean_abs_err"], (name, errors)
        assert dev == 1, dev
        records[name] = dict(
            shape=[b, heads, n, hd], grid=[h, w], ms=ms, module_ms=module_ms,
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms,
            bound_by=by, roofline=bms / ms, span_bound_ms=span_bms,
            span_roofline=span_bms / module_ms, device_launches=dev,
            geometry=list(ak.attention_geometry(w)), **errors)
        del m, qkv, args, q, k, v
        torch.cuda.empty_cache()
    return records


def attention_check() -> int:
    """phase_attention alone, after the kernels' build (nvcc's resource
    report of the attention kernels first): prints its record as one JSON
    line. Run on the card with python3 -c "import chip_smoke, sys;
    sys.exit(chip_smoke.attention_check())"."""
    import torch

    from tee_optical_flow_torch.ops import cuda_lib

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    phase_setup()
    report = cuda_lib.build_info["ptxas"].splitlines()
    for i, line in enumerate(report):
        if "relpos_attention" in line:
            log(" | ".join(x.strip() for x in report[i:i + 4]))
    print(json.dumps({"attention": phase_attention()}))
    return 0


def attention_tuning(shapes=None):
    """The attention kernel in each geometry the source can build (8 warps
    of one 16-row tile, 4 of two; the within-a-row bias path where the
    grid allows it, and the other), from the library built with
    RPA_ALL_GEOMETRIES, at ATTN_SHAPES and ATTN_TUNING_SHAPES: mean ms
    (CUDA events), the share of the kernel's bound, the gap from the
    default geometry's output. The basis of ops/attention_kernels
    .attention_geometry. Run on the card with python3 -c "import
    chip_smoke; chip_smoke.attention_tuning()"."""
    import torch

    from tee_optical_flow_torch.ops import attention_kernels as ak
    from tee_optical_flow_torch.ops.cuda_lib import load_library

    log(f"card: {phase_setup()[0]}")
    lib = load_library({"RPA_ALL_GEOMETRIES": 1})
    for name, (b, heads, h, w, hd) in (
            shapes or {**ATTN_SHAPES, **ATTN_TUNING_SHAPES}).items():
        m = attention_module(heads, hd, h, w, torch.bfloat16, "cuda")
        bms, _ = attention_bound(b, heads, h, w, hd)
        with torch.no_grad():
            args = attention_args(m, attention_qkv(m, b, h, w), h, w)
            ref = ak.rel_pos_attention(*args).float()
            default = ak.attention_geometry(w)
            for geometry in ((8, 1), (4, 2)):
                for tile_row in sorted({False, w % ak.KEY_TILE == 0}):
                    g = (*geometry, tile_row)

                    def run():
                        return ak._launch(*args, g, lib)

                    diff = float((run().float() - ref).abs().max())
                    ms = cuda_ms(run, 10)
                    log(f"attention tuning {name} (N {h * w}) geometry {g}"
                        f"{' (default)' if g == default else ''}: {ms:.4f} "
                        f"ms ({100 * bms / ms:.1f}% of {bms:.4f} ms), max-abs"
                        f" {diff:.3g} from the default geometry's")
        del m, args, ref
        torch.cuda.empty_cache()


def phase_saliency(clip):
    """fine_grained_saliency of the clip's gray frames on the card against
    the same call on the CPU, within 1e-4."""
    import torch

    from tee_optical_flow_torch.ops.imaging import gray_from_clip
    from tee_optical_flow_torch.ops.saliency import fine_grained_saliency

    gray = gray_from_clip(torch.from_numpy(clip).cuda())
    got = fine_grained_saliency(gray)
    ref = fine_grained_saliency(gray.cpu())
    err = float((got.cpu() - ref).abs().max())
    log(f"saliency {tuple(gray.shape)}: max|card - CPU| = {err:.3g} "
        f"(tolerance 1e-4)")
    assert got.shape == gray.shape and err <= 1e-4, err


def cpu_wall_reference(windows=(0, 3, 7)):
    """The DeepFlow wall EPE of the port on the CPU at the production
    settings, on windows of two pairs of the smoke's clip: the reference
    for DF_WALL_*. Run with
    python3 -c "import chip_smoke; chip_smoke.cpu_wall_reference()"."""
    import torch

    from tee_optical_flow_torch.config import default_optical_flow_config
    from tee_optical_flow_torch.flow.pipeline import compute_clip_flow
    from tee_optical_flow_torch.ops.imaging import gray_from_clip, img2uint8
    from tee_optical_flow_torch.synthetic import echo_sector_masks

    clip, truth = echo_clip(CLIP_FRAMES, CLIP_H, CLIP_W)
    wall = echo_sector_masks(CLIP_H, CLIP_W)["wall"].copy()
    wall[:8] = wall[-8:] = False
    wall[:, :8] = wall[:, -8:] = False
    cf = np.float32(SPACING_CM * FPS)
    for k in windows:
        images = img2uint8(gray_from_clip(torch.from_numpy(
            np.ascontiguousarray(clip[k:k + 3]))))
        flow = compute_clip_flow(images, "deepflow",
                                 default_optical_flow_config(),
                                 device="cpu").numpy()
        # stored as float16 cm/s, read back in px, as check_outputs does
        px = (flow * cf).astype(np.float16).astype(np.float32) / cf
        tr = truth[k:k + 2]
        epe = np.hypot(px[..., 0] - tr[..., 0], px[..., 1] - tr[..., 1])
        epe = epe[:, wall]
        motion = np.median(np.hypot(tr[..., 0], tr[..., 1])[:, wall])
        log(f"pairs {k}-{k + 1}: median motion {motion:.3f} px, EPE median "
            f"{np.median(epe):.4f} px, p95 {np.percentile(epe, 95):.4f} px")


def k3_tuning():
    """K3 under each build of K3_VARIANTS at the five levels of the
    DeepFlow path, on the arguments the path hands K3 on the smoke's clip
    (compute_clip_flow, recorded as in the smoke): mean ms over 10 calls
    (CUDA events), device launches per call, own-traffic rate and
    bit-equality with the plain version. The basis of csrc/deepflow.cu's
    S, extended tile and resident route. Run on the card with
    python3 -c "import chip_smoke; chip_smoke.k3_tuning()"."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from tee_optical_flow_torch.config import default_optical_flow_config
    from tee_optical_flow_torch.flow.pipeline import compute_clip_flow
    from tee_optical_flow_torch.ops import cuda_lib
    from tee_optical_flow_torch.ops import deepflow_kernels as dk
    from tee_optical_flow_torch.ops.imaging import gray_from_clip, img2uint8

    log(f"card: {phase_setup()[0]}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        libs = list(pool.map(cuda_lib.load_library, K3_VARIANTS))
    log(f"{len(libs)} builds of the kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    clip, _ = echo_clip(CLIP_FRAMES, CLIP_H, CLIP_W)
    # the path's 33 frames, bucketed to 40 as process_video pads them
    frames = np.concatenate([clip, np.repeat(clip[-1:], 7, axis=0)])
    images = img2uint8(gray_from_clip(torch.from_numpy(frames).cuda()))
    captured, calls = {}, {}
    with record_k3(captured, calls):
        compute_clip_flow(images, "deepflow", default_optical_flow_config())
    assert set(captured) == set(K3_SHAPES), list(captured)
    for shape in K3_SHAPES:
        args, kw = captured[shape]
        planes, match = args[:10], args[10] if len(args) > 10 else None
        b, h, w = planes[0].shape
        ref = dk.sor_sweeps_plain(*planes, match, **kw)
        for defines, lib in zip(K3_VARIANTS, libs):
            def run():
                return dk.solve(lib, planes, match, **kw)

            err = max_abs(run(), ref)
            ms = cuda_ms(run, 10)
            dev = device_launches(run, DEEPFLOW_DEVICE_KERNELS, lib)
            s = defines.get("K3_S", K3_S)
            tile = (defines.get("K3_EW", K3_TILE[0]),
                    defines.get("K3_EH", K3_TILE[1]))
            resident = dk.resident(lib, h, w)
            own = k3_own_bytes(b, h, w, bool(match), kw["psi_iters"],
                               kw["sor_iters"], resident, s, tile)
            log(f"K3 tuning ({b},{h},{w}) {'match' if match else 'no match'}"
                f" {defines or 'production'}: {ms:.4f} ms, {dev} device "
                f"launches per call ({'resident' if resident else 'tiled'}), "
                f"max|kernel - plain| {err}, own traffic "
                f"{own / (b * h * w):.1f} B per pixel at "
                f"{own / ms / 1e9:.3f} TB/s")
            assert err == 0.0, (shape, defines, err)
            assert dev == k3_device_launches(resident, kw["psi_iters"],
                                             kw["sor_iters"], s), dev


def k2_tuning():
    """The block loop under each build of K2_VARIANTS, on the arguments
    the 600x800 TV-L1 path hands it (compute_clip_flow on the K2 path's
    clip, recorded as in the smoke), at the path's epsilon 0.01 and at 0:
    mean ms over 3 calls (CUDA events), device launches per call,
    own-traffic rate and equality with the plain version. The basis of
    csrc/tvl1.cu's K2_S and extended tile. Run on the card with
    python3 -c "import chip_smoke; chip_smoke.k2_tuning()"."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from tee_optical_flow_torch.config import default_optical_flow_config
    from tee_optical_flow_torch.flow.pipeline import compute_clip_flow
    from tee_optical_flow_torch.ops import cuda_lib
    from tee_optical_flow_torch.ops import tvl1_kernels as tk
    from tee_optical_flow_torch.ops.imaging import gray_from_clip, img2uint8

    log(f"card: {phase_setup()[0]}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        libs = list(pool.map(cuda_lib.load_library, K2_VARIANTS))
    log(f"{len(libs)} builds of the kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    clip, _ = echo_clip(K2_FRAMES, K2_H, K2_W)
    frames = np.concatenate([clip, np.repeat(clip[-1:], 7, axis=0)])
    images = img2uint8(gray_from_clip(torch.from_numpy(frames).cuda()))
    captured, calls = {}, {}
    with record_tvl1("tvl1_block_loop", (K2_SHAPE,), captured, calls):
        compute_clip_flow(images, "TVL1", default_optical_flow_config())
    args, kw = captured[K2_SHAPE]
    b, h, w = args[0].shape
    for eps in (0.01, 0.0):
        kwe = dict(kw, epsilon=eps)
        ref = tk.tvl1_block_loop_plain(*args, **kwe)
        if eps > 0:
            blocks = tk.block_loop_stops(args, ref, near=0.0, **kwe)[0]
        else:
            blocks = [kw["outer_iters"]] * b
        for defines, lib in zip(K2_VARIANTS, libs):
            def run():
                return tk.block_loop(lib, args, **kwe)

            err = max_abs(run(), ref)
            ms = cuda_ms(run, 3)
            dev = device_launches(run, TVL1_DEVICE_KERNELS, lib)
            s = defines.get("K2_S", K2_S)
            tile = (defines.get("K2_EW", K2_TILE[0]),
                    defines.get("K2_EH", K2_TILE[1]))
            sweeps = lib.tvl1_block_sweeps(kw["inner_iters"])
            own = sum(blocks) * k2_own_bytes(h, w, kw["inner_iters"], sweeps,
                                             s=s, tile=tile)
            log(f"K2 tuning ({b},{h},{w}) eps={eps} "
                f"{defines or 'production'}: {ms:.4f} ms, {dev} device "
                f"launches per call, max|kernel - plain| {err}, own traffic "
                f"{own / (sum(blocks) * kw['inner_iters'] * h * w):.2f} B "
                f"per pixel-step at {own / ms / 1e9:.3f} TB/s")
            assert dev == k2_device_launches(lib, kw["outer_iters"],
                                             kw["inner_iters"], eps), dev
            if eps == 0:
                assert err == 0.0, (defines, err)


def k2_stops(args, got, kw):
    """The block loop's result ``got`` held to the plain version at
    epsilon > 0 (tvl1_kernels.block_loop_stops): every pair bit-equal to
    the plain state after a block count its stop reaches when a decision
    within K2_NEAR of the threshold flips. Returns the blocks each pair
    ran in ``got`` (the plain version's count where that is one of them),
    the pairs that came that near, and the least margin."""
    from tee_optical_flow_torch.ops import tvl1_kernels as tk

    blocks, reachable, matched, margin = tk.block_loop_stops(
        args, got, near=K2_NEAR, **kw)
    ran = []
    for j, n in enumerate(blocks):
        both = reachable[j] & matched[j]
        assert both, (j, reachable[j], matched[j], margin[j])
        ran.append(n if n in both else min(both))
    near = [j for j in range(len(blocks)) if reachable[j] != {blocks[j]}]
    return ran, near, min(margin)


def phase_k2(captured, calls):
    """The block loop against its plain version on the arguments the
    600x800 TV-L1 path gave it at its finest level (39x608x800), first
    warp: bit-equal at epsilon 0; at the path's 0.01 every pair bit-equal
    to the plain state after a block count the stop reaches when a
    decision within K2_NEAR of the threshold flips (k2_stops). Times it
    per warp call (CUDA events), counts its device launches per call,
    times it and counts its device launches on every warp's arguments
    (its device time and launches per clip), and holds and times K2 alone
    (tvl1_inner_block, one block of steps) and the standalone median on
    the first warp's."""
    import torch

    from tee_optical_flow_torch.ops import tvl1_kernels as tk
    from tee_optical_flow_torch.ops import warp as tw
    from tee_optical_flow_torch.ops.cuda_lib import load_library

    log(f"block-loop calls per level shape in the first 600x800 run: "
        f"{ {f'{h}x{w}': c for (h, w), c in calls.items()} }")
    assert calls == {K2_SHAPE: TV_WARPS}, calls
    args, kw = captured[K2_SHAPE][0]
    assert kw["epsilon"] == 0.01 and kw["use_median"], kw
    lib = load_library()
    b, h, w = args[0].shape
    npx = b * h * w
    outer, inner = kw["outer_iters"], kw["inner_iters"]
    sweeps = lib.tvl1_block_sweeps(inner)
    out = {}
    for eps in (0.01, 0.0):
        kwe = dict(kw, epsilon=eps)
        tag = f"block loop ({b},{h},{w}) path args eps={eps}"
        got = tk.tvl1_block_loop(*args, **kwe)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = tk.tvl1_block_loop_plain(*args, **kwe)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        diff = [max(float((x[j] - y[j]).abs().max())
                    for x, y in zip(got, ref)) for j in range(b)]
        err = max(diff)
        if eps > 0:
            blocks, near, margin = k2_stops(args, got, kwe)
            log(f"{tag}: max|kernel - plain| = {err}; every pair bit-equal "
                f"to the plain state after a block count its stop reaches "
                f"when a decision within {K2_NEAR} of the threshold flips; "
                f"{len(near)} pairs came that close: {near}, their max-abs "
                f"{max([diff[j] for j in near], default=0.0)}; least margin "
                f"{margin:.3g}")
        else:
            blocks, near = [outer] * b, []
            log(f"{tag}: max|kernel - plain| = {err} (tolerance 0)")
            assert err == 0.0, err
        assert all(bool(torch.isfinite(t).all()) for t in got)
        ms = cuda_ms(lambda: tk.tvl1_block_loop(*args, **kwe), 3)
        want = k2_device_launches(lib, outer, inner, eps)
        dev = device_launches(lambda: tk.tvl1_block_loop(*args, **kwe),
                              TVL1_DEVICE_KERNELS)
        assert dev == want, (tag, dev, want)
        pair_blocks = sum(blocks)
        pair_steps = pair_blocks * inner
        ops_px = (pair_steps * OPS_STEP + pair_blocks
                  * (2 * OPS_MEDIAN_PLANE + (OPS_ERR if eps > 0 else 0)))
        bms, by = bound(16 * 4 * npx, ops_px * h * w)
        own = pair_blocks * k2_own_bytes(h, w, inner, sweeps)
        log(f"{tag}: {pair_blocks} of {b * outer} pair-blocks "
            f"({pair_steps} pair-steps) ran; {ms:.3f} ms kernel, "
            f"{plain_ms:.3f} ms plain, bound {bms:.4f} ms ({by}), {dev} "
            f"device launches per call; own traffic "
            f"({own / (pair_steps * h * w):.2f} B per pixel-step) at "
            f"{own / ms / 1e9:.3f} TB/s")
        out[eps] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, shape=[b, h, w],
                        pair_blocks=pair_blocks, pair_steps=pair_steps,
                        device_launches=dev, near_threshold_pairs=near)

    # per clip: every warp's call, each timed alone and its device launches
    # counted by the profiler
    clip_ms = clip_dev = 0
    for a, k in captured[K2_SHAPE]:
        clip_ms += cuda_ms(lambda: tk.tvl1_block_loop(*a, **k), 3)
        want = k2_device_launches(lib, outer, inner, k["epsilon"])
        dev = device_launches(lambda: tk.tvl1_block_loop(*a, **k),
                              TVL1_DEVICE_KERNELS)
        assert dev == want, (dev, want)
        clip_dev += dev
    out["clip_device_ms"] = clip_ms
    out["clip_device_launches"] = clip_dev
    log(f"block loop per 600x800 clip: {clip_ms:.2f} ms over {clip_dev} "
        f"device launches (the sums over its {len(captured[K2_SHAPE])} warp "
        f"calls, each timed alone and traced)")

    # K2 alone: one block of steps, no median, no stop
    kw2 = dict(n_iters=inner, l_t=kw["l_t"], theta=kw["theta"],
               taut=kw["taut"])
    got = tk.tvl1_inner_block(*args, **kw2)
    ref = tk.tvl1_inner_block_plain(*args, **kw2)
    err = max_abs(got, ref)
    log(f"K2 tvl1_inner_block ({b},{h},{w}) {inner} steps: max|kernel - "
        f"plain| = {err} (tolerance 0: bit-equal)")
    assert err == 0.0, err
    ms = cuda_ms(lambda: tk.tvl1_inner_block(*args, **kw2), 5)
    plain_ms = cuda_ms(lambda: tk.tvl1_inner_block_plain(*args, **kw2), 2)
    dev = device_launches(lambda: tk.tvl1_inner_block(*args, **kw2),
                          TVL1_DEVICE_KERNELS)
    assert dev == sweeps, (dev, sweeps)
    bms, by = bound(16 * 4 * npx, inner * OPS_STEP * npx)
    own = b * k2_own_bytes(h, w, inner, sweeps, use_median=False)
    log(f"K2 alone: {ms:.3f} ms kernel per block, {plain_ms:.3f} ms plain, "
        f"bound {bms:.4f} ms ({by}), {dev} device launches; own traffic "
        f"({own / (inner * npx):.2f} B per pixel-step) at "
        f"{own / ms / 1e9:.3f} TB/s")
    out["k2_alone"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bms, bound_by=by, device_launches=dev)

    # the standalone median (no path launches it): bit-equal
    u = args[4]
    got = tw.median_filter_5x5(u)
    ref = tw.median_filter_5x5_plain(u)
    err = float((got - ref).abs().max())
    log(f"median 5x5 ({b},{h},{w}): max|kernel - plain| = {err} "
        f"(tolerance 0: bit-equal)")
    assert torch.equal(got, ref), err
    ms = cuda_ms(lambda: tw.median_filter_5x5(u), 20)
    plain_ms = cuda_ms(lambda: tw.median_filter_5x5_plain(u), 5)
    bms, by = bound(2 * 4 * npx, OPS_MEDIAN_PLANE * npx)
    log(f"median: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, bound "
        f"{bms:.4f} ms ({by})")
    out["median"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by, shape=[b, h, w])
    return out


def sam_segmentor(captured):
    """The SAM path's segmentor: vit_t at 1024 with SAM_CLASSES classes,
    seeded random weights, bfloat16, micro-batch SAM_MICRO_BATCH. Its
    labels_device appends each call's labels to ``captured``."""
    import torch

    from tee_optical_flow_torch.models import (
        build_sam_vit_t, make_clip_segmentor,
    )

    return record_labels(make_clip_segmentor(build_sam_vit_t(
        num_classes=SAM_CLASSES, seed=SAM_SEED, dtype=torch.bfloat16),
        micro_batch=SAM_MICRO_BATCH), captured)


def masks_match_cpu(lab, masks, tag, windows=SAM_WINDOWS):
    """The masks of a segmentor path against the port's clean_mask on the
    CPU over the card's labels ``lab`` (all bucketed frames, on the host),
    bit-equal at the frames ``windows``, each from the window of labels
    its masks depend on (frames k-1 to k+2; ~15 s a window on the CPU)."""
    from tee_optical_flow_torch.config import default_optical_flow_config
    from tee_optical_flow_torch.flow.segment import clean_mask

    cfg = default_optical_flow_config()
    shares = np.bincount(lab.numpy().ravel(), minlength=SAM_CLASSES)
    log(f"{tag} labels {tuple(lab.shape)} (bucketed clip): class shares "
        f"{np.round(shares / shares.sum(), 4).tolist()}; mask coverage "
        + ", ".join(f"{k} {float(v[..., 0].mean()):.4f}"
                    for k, v in masks.items()))
    t0 = time.perf_counter()
    for k in windows:
        lo = max(k - 1, 0)
        ref = clean_mask(lab[lo:k + 3], "RVIO_2class", config=cfg)
        for name, mask in masks.items():
            assert np.array_equal(mask[k], ref[name][k - lo]), (name, k)
    log(f"{tag} masks at frames {windows} bit-equal to clean_mask on "
        f"the CPU over the card's labels ({time.perf_counter() - t0:.1f} s)")


def phase_sam_masks(labels, masks, dcm, seg):
    """The SAM path's masks against the port's clean_mask run on the CPU
    over the card's own labels (the last run's, all bucketed frames):
    bit-equal at the frames of SAM_WINDOWS, each from the window of labels
    its masks depend on (frames k-1 to k+2; the whole clip's labelling on
    the CPU would take ~15 min). Then the segmentation stage's two parts
    timed apart on the card (host clock to a synchronise): the segmentor
    on the clip, and clean_mask of its labels in RVIO_2class (2 labels)
    and in A4C (8 labels: the labelling costs the same whatever the
    labels hold)."""
    import torch

    from tee_optical_flow_torch.config import default_optical_flow_config
    from tee_optical_flow_torch.flow.segment import clean_mask
    from tee_optical_flow_torch.io.dicom import read_dicom_clip

    cfg = default_optical_flow_config()
    lab = labels.cpu()
    masks_match_cpu(lab, masks, "SAM")

    _, arr = read_dicom_clip(dcm)
    gray = np.concatenate([arr, np.repeat(arr[-1:], lab.shape[0]
                                          - arr.shape[0], axis=0)])[..., 0]
    clip_dev = torch.from_numpy(np.ascontiguousarray(gray)).cuda()
    h, w = gray.shape[1:]
    # both parts are warm: the path's three clips ran them
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels = seg.labels_device(clip_dev, (h, w))
    torch.cuda.synchronize()
    stages = {"segmentor_s": time.perf_counter() - t0}
    for mode in ("RVIO_2class", "A4C"):
        t0 = time.perf_counter()
        clean_mask(labels, mode, config=cfg)
        torch.cuda.synchronize()
        stages[f"clean_mask_{mode}_s"] = time.perf_counter() - t0
    log(f"SAM segmentation stage apart, {lab.shape[0]} frames: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    return stages


def phase_sam(clip):
    """The vit_t SAM model at 1024 on the card, seeded random weights:
    float32 logits of the clip's first 2 frames against the CPU with TF32
    off (SAM_F32_*), bfloat16 against float32 on the card (SAM_BF16_*),
    micro-batch 1 against 4 (label agreement, printed), and the
    segmentor's ms per frame at micro-batch 4 (CUDA events) in bfloat16
    and in float32 with TF32 off and on, beside the FLOPs per frame the
    matrix products and convolutions do (torch's FlopCounterMode, from
    their shapes) and the share of the card's dense peak for the type."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from tee_optical_flow_torch.models import (
        build_sam_vit_t, make_clip_segmentor, preprocess_frames,
    )

    n, h, w = clip.shape
    kw = dict(num_classes=SAM_CLASSES, seed=SAM_SEED)
    cpu = build_sam_vit_t(device="cpu", **kw)
    f32 = build_sam_vit_t(**kw)
    bf16 = build_sam_vit_t(dtype=torch.bfloat16, **kw)
    frames = np.ascontiguousarray(clip[:2])

    def logits(model, device):
        with torch.no_grad():
            x = preprocess_frames(torch.from_numpy(frames).to(device),
                                  model.image_size)
            return model(x)[0].float().cpu()

    assert not (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)
    t0 = time.perf_counter()
    ref = logits(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    got = logits(f32, "cuda")
    side = f32.image_size // 4
    assert got.shape == (2, SAM_CLASSES, side, side), got.shape
    assert bool(torch.isfinite(got).all())
    err = float((got - ref).abs().max())
    rel = err / float(ref.max() - ref.min())
    agree = float((got.argmax(1) == ref.argmax(1)).float().mean())
    log(f"SAM vit_t float32, TF32 off, 2 frames: card vs CPU logits max-abs "
        f"{err:.3g} (bound {SAM_F32_ATOL}), {rel:.3g} of their range "
        f"[{float(ref.min()):.3f}, {float(ref.max()):.3f}] (bound "
        f"{SAM_F32_REL}); labels agree {agree:.6f} (bound {SAM_F32_AGREE}); "
        f"CPU forward {cpu_s:.1f} s")
    assert err < SAM_F32_ATOL and rel < SAM_F32_REL, (err, rel)
    assert agree >= SAM_F32_AGREE, agree
    low = logits(bf16, "cuda")
    err16 = float((low - got).abs().max())
    rel16 = err16 / float(got.max() - got.min())
    agree16 = float((low.argmax(1) == got.argmax(1)).float().mean())
    log(f"SAM bfloat16 vs float32 on the card: labels agree {agree16:.5f} "
        f"(bound {SAM_BF16_AGREE}), logits max-abs {err16:.4f} = "
        f"{rel16:.4f} of the range (bound {SAM_BF16_REL})")
    assert agree16 >= SAM_BF16_AGREE and rel16 < SAM_BF16_REL, \
        (agree16, rel16)

    clip8 = torch.from_numpy(np.ascontiguousarray(clip[:8])).cuda()
    by_mb = {mb: make_clip_segmentor(bf16, micro_batch=mb).labels_device(
        clip8, (h, w)) for mb in (1, SAM_MICRO_BATCH)}
    agree_mb = float((by_mb[1] == by_mb[SAM_MICRO_BATCH]).float().mean())
    log(f"SAM bfloat16 labels, micro-batch 1 vs {SAM_MICRO_BATCH} on 8 "
        f"frames: agree {agree_mb:.6f}")

    clip4 = clip8[:SAM_MICRO_BATCH]
    # with grad on: the counter's module hooks need the autograd graph
    with FlopCounterMode(display=False) as counter:
        f32(preprocess_frames(clip4[:1], f32.image_size))
    flops = counter.get_total_flops()
    timing = {}
    try:
        for tag, model, tf32, peak in (
                ("bf16", bf16, False, BF16_DENSE_OPS_PER_S),
                ("f32", f32, False, FP32_OPS_PER_S),
                ("f32_tf32", f32, True, TF32_DENSE_OPS_PER_S)):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            seg = make_clip_segmentor(model, micro_batch=SAM_MICRO_BATCH)
            ms = cuda_ms(lambda: seg.labels_device(clip4, (h, w)), 5)
            ms_frame = ms / SAM_MICRO_BATCH
            share = flops / (ms_frame * 1e-3) / peak
            timing[tag] = dict(ms_per_frame=ms_frame, share_of_peak=share)
            log(f"SAM segmentor {tag} (TF32 {'on' if tf32 else 'off'}), "
                f"micro-batch {SAM_MICRO_BATCH}: {ms_frame:.3f} ms per "
                f"frame; {flops / 1e9:.2f} GFLOP per frame -> "
                f"{flops / (ms_frame * 1e-3) / 1e12:.2f} TFLOP/s, "
                f"{100 * share:.2f}% of the {peak / 1e12:.0f} TFLOP/s peak")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dict(f32_max_abs=err, f32_rel=rel, f32_agree=agree,
                bf16_agree=agree16, bf16_rel=rel16, mb_agree=agree_mb,
                gflop_per_frame=flops / 1e9, timing=timing)



def geometry_labels(h, w):
    """(h, w) uint8 labels from the synthetic clip's geometry: rv (1) the
    wall ring, av (2) a disc at the ring centre of radius
    COHORT_AV_RADIUS x h, background (0) the rest."""
    from tee_optical_flow_torch.synthetic import echo_sector_masks

    geo = echo_sector_masks(h, w)
    yy, xx = np.mgrid[0:h, 0:w]
    av = np.hypot(yy - 0.55 * h, xx - 0.5 * w) < COHORT_AV_RADIUS * h
    label_map = np.zeros((h, w), np.uint8)
    label_map[geo["wall"]] = 1
    label_map[av] = 2
    return label_map


def cohort_inputs(h, w, folder, base):
    """The config-4 path's label callable (from the clip's geometry) and
    its companion waveforms, written as ``<base>_II.npy`` and
    ``<base>_ART.npy`` into ``folder`` with numpy only."""
    label_map = geometry_labels(h, w)

    def labels(frames):
        return np.broadcast_to(label_map, np.asarray(frames).shape[:3]).copy()

    seconds = CLIP_FRAMES / COHORT_FPS
    t_ecg = np.arange(int(seconds * 500)) / 500.0
    ecg = 0.05 * np.sin(2 * np.pi * 0.4 * t_ecg)
    for beat in COHORT_BEATS_S:
        c = int(beat * 500)
        ecg[c - 10:c + 11] += 1.2 * np.hanning(21)
    t_art = np.arange(int(seconds * 125)) / 125.0
    art = 80 + 20 * np.sin(2 * np.pi * (t_art - 0.3))
    np.save(os.path.join(folder, f"{base}_II.npy"), ecg)
    np.save(os.path.join(folder, f"{base}_ART.npy"), art)
    shares = np.bincount(label_map.ravel(), minlength=3) / label_map.size
    return labels, shares


@contextlib.contextmanager
def substituted(module, name, fn):
    """Replace ``module.name`` by ``fn`` inside the block."""
    inner = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, inner)


def record_labels(seg, store):
    """The segmentor ``seg`` with its labels_device appending each call's
    labels to ``store``."""
    inner = seg.labels_device

    def recording(clip, clip_hw):
        store.append(inner(clip, clip_hw))
        return store[-1]

    seg.labels_device = recording
    return seg


@contextlib.contextmanager
def record_wase(captured):
    """Wrap the pipeline's wase_background: keep its arguments and its
    output in ``captured``; restore it on exit."""
    from tee_optical_flow_torch.flow import pipeline as pl

    inner = pl.wase_background

    def recording(flow_pairs, bkgd):
        out = inner(flow_pairs, bkgd)
        captured.update(flow=flow_pairs.clone(), bkgd=bkgd.clone(), out=out)
        return out

    with substituted(pl, "wase_background", recording):
        yield


def phase_cohort(clip, workdir):
    """BASELINE config 4 at full width: the 33x480x640 clip through
    process_video(mode="RVIO_2class", OF_algo="TVL1", bkgd_comp="WASE",
    include_waveforms=True) with the geometry label callable and the
    synthetic waveforms; the port's dataset from the saved arrays in
    memory; the cohort row for velocity/rv under the default
    AnalysisConfig (nbins 1000) through both gates (batch/cohort's
    _cohort_row, what analyze_cohort_file computes before its plots).

    Checks: 25 K1 calls in the clip; WASE against the float64 host
    background on the card's own flow and bkgd mask; the card's histogram
    packs bit-equal to the plain CPU pack on the card's own inputs; the
    AV centroid at COHORT_CENTROID_FRAMES equal to the CPU's; 69 values
    with nonzero ECG and arterial sections and n_cycles >= 1 in each
    gate; the row equal to the CPU's (everything but the centroid
    labelling recomputed on the CPU, from the card's centroid track).
    Prints each stage's seconds (log() puts the card's name and power
    limit on every line)."""
    import torch

    from tee_optical_flow_torch.analysis import centroid as cen
    from tee_optical_flow_torch.analysis import histograms as hist
    from tee_optical_flow_torch.analysis.components import (
        calculate_comp_magnitude,
    )
    from tee_optical_flow_torch.batch import cohort
    from tee_optical_flow_torch.config import (
        AnalysisConfig, ProcessingConfig, VisualizationConfig,
        default_optical_flow_config,
    )
    from tee_optical_flow_torch.dataset import OpticalFlowDataset
    from tee_optical_flow_torch.flow.pipeline import process_video
    from tee_optical_flow_torch.io.hdf5 import optical_flow_layout
    from tee_optical_flow_torch.ops.histogram import (
        framewise_hist_pack_group,
    )
    from tee_optical_flow_torch.ops.morphology import largest_centroid_series
    from tee_optical_flow_torch.viz.manager import VisualizationManager

    n, h, w = clip.shape
    base = "echo_config4"
    labels, shares = cohort_inputs(h, w, workdir, base)
    log(f"--- config 4: process_video(mode='RVIO_2class', OF_algo='TVL1', "
        f"bkgd_comp='WASE', include_waveforms=True) on {n}x{h}x{w} at "
        f"{COHORT_FPS} frames/s; geometry labels, pixel shares background "
        f"{shares[0]:.4f}, rv {shares[1]:.4f}, av {shares[2]:.4f}")
    saved, wase = {}, {}

    def capture(save_path, flow_arr, echo_gray, mask_dict, metadata,
                waveforms, verbose=False, **kw):
        saved["layout"] = optical_flow_layout(flow_arr, echo_gray, mask_dict,
                                              metadata, waveforms, **kw)

    meta = {"pixel_spacing": SPACING_CM, "frame_rate": COHORT_FPS,
            "R_times": None, "R_wave_data_present": False}
    stages = {}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with record_wase(wase):
        process_video(
            os.path.join(workdir, base + ".dcm"), "unused.hdf5", labels,
            verbose=False, mode="RVIO_2class", OF_algo="TVL1",
            no_saliency=True, bkgd_comp="WASE", include_waveforms=True,
            waveform_folder=workdir, config=default_optical_flow_config(),
            _clip_override=np.repeat(clip[..., None], 3, axis=-1),
            _metadata_override=meta, _save_fn=capture)
    torch.cuda.synchronize()
    stages["process_video_s"] = time.perf_counter() - t0
    counts = read_counts()
    log(f"config 4 process_video: {stages['process_video_s']:.3f} s, "
        f"launches {counts}")
    assert counts == dict(_NONE, tvl1_outer_loop=TV_LEVELS * TV_WARPS,
                          connected_components=RVIO_LABELLINGS), counts
    layout = saved["layout"]
    assert {"ecg", "art", "rv", "av", "bkgd"} <= set(layout), list(layout)
    assert layout["flow"][1]["waveforms_present"]

    # WASE against the float64 host background on the card's own inputs
    flow64 = wase["flow"].double().cpu()
    b_sum = wase["bkgd"].double().sum(dim=0).cpu()[..., None]
    total = (flow64 * b_sum).sum(dim=(1, 2, 3))
    count = ((flow64 != 0).double() * b_sum).sum(dim=(1, 2, 3))
    bg64 = torch.where(count > 0, total / count, torch.zeros_like(total))
    err = float((wase["out"].double().cpu()
                 - (flow64 - bg64[:, None, None, None])).abs().max())
    log(f"WASE {tuple(wase['flow'].shape)} with bkgd "
        f"{tuple(wase['bkgd'].shape)}: backgrounds {float(bg64.min()):.5f} "
        f"to {float(bg64.max()):.5f} px; max|card - float64 host| = "
        f"{err:.3g} px (bound {COHORT_WASE_ATOL})")
    assert err <= COHORT_WASE_ATOL, err
    del wase

    ds = OpticalFlowDataset(base + ".hdf5", _file_override=layout)
    assert ds.nframes == n - 2 and ds.waveforms_present
    cfg, proc = AnalysisConfig(), ProcessingConfig()
    manager = VisualizationManager(
        vis_config=VisualizationConfig(show_img=False), proc_config=proc)

    # the row, as analyze_cohort_file computes it before its plots
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sections, _ = cohort._cohort_row(ds, "velocity", "rv", cfg, proc,
                                     device="cuda")
    row = cohort._assemble_row(ds, sections)
    stages["row_first_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sections, _ = cohort._cohort_row(ds, "velocity", "rv", cfg, proc,
                                     device="cuda")
    row = cohort._assemble_row(ds, sections)
    stages["row_s"] = time.perf_counter() - t0

    # its stages apart, warm, each to a synchronise
    masked = ds.device_masked_arr("velocity", "rv", device="cuda")
    nf = ds.nframes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist.calculate_3dhist(masked, nf, nbins=cfg.nbins,
                          percentile=cfg.percentile)
    stages["hist_pass_s"] = time.perf_counter() - t0
    av_dev = torch.from_numpy(np.ascontiguousarray(
        ds.get_mask("av")[:nf, :, :, 0])).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cents_dev, _, valid_dev = largest_centroid_series(av_dev)
    torch.cuda.synchronize()
    stages["centroid_labelling_s"] = time.perf_counter() - t0
    cents = cen.calc_AV_centroid(ds.get_mask("av"), nf, device="cuda")
    t0 = time.perf_counter()
    rad, lng = calculate_comp_magnitude(masked, cents)
    hist._radlong_hists(rad, lng, nf, cfg.nbins, cfg.perc_lo, cfg.perc_hi)
    stages["radlong_pass_s"] = time.perf_counter() - t0
    filt, traces = cohort._cohort_traces(ds, "velocity", "rv", manager, cfg,
                                         device="cuda")
    t0 = time.perf_counter()
    cohort._cohort_sections(ds, filt, traces, manager, proc)
    stages["gating_and_peaks_s"] = time.perf_counter() - t0
    log("config 4 stages (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))

    # the row's shape and content
    assert len(row) == 69, len(row)
    ecg_total, art_total = row[15:24], row[24:33]
    ecg_radlong, art_radlong = row[33:51], row[51:69]
    for name, sec in (("ecg_total", ecg_total), ("art_total", art_total),
                      ("ecg_radlong", ecg_radlong),
                      ("art_radlong", art_radlong)):
        assert any(v != 0 for v in sec), (name, sec)
        assert all(np.isfinite(float(v)) for v in sec), (name, sec)
    cycles = {"ecg": (row[23], row[49], row[50]),
              "art": (row[32], row[67], row[68])}
    assert all(c >= 1 for v in cycles.values() for c in v), cycles
    log(f"config 4 row: 69 values, n_cycles {cycles}; ECG total "
        f"{[round(float(v), 4) for v in ecg_total]}; ART total "
        f"{[round(float(v), 4) for v in art_total]}")

    # the centroid on the CPU at a few frames
    t0 = time.perf_counter()
    frames = list(COHORT_CENTROID_FRAMES)
    c_cpu, _, v_cpu = largest_centroid_series(av_dev[frames].cpu())
    assert torch.equal(c_cpu, cents_dev[frames].cpu()), (c_cpu, cents_dev)
    assert torch.equal(v_cpu, valid_dev[frames].cpu())
    log(f"AV centroid at frames {frames} equal on the card and the CPU "
        f"({c_cpu.tolist()}; {time.perf_counter() - t0:.1f} s of CPU "
        f"labelling)")

    # the packs: card against the plain CPU version on the card's inputs
    mag, ang = hist.cart_to_polar(masked[:nf])
    t0 = time.perf_counter()
    for name, group, percs in (
            ("mag/ang", torch.stack([mag, ang]), [[cfg.percentile], [50]]),
            ("rad/long", torch.stack([rad, lng]),
             [[cfg.perc_lo, cfg.perc_hi]] * 2)):
        p = torch.tensor(percs, dtype=torch.float32)
        got = framewise_hist_pack_group(group, p, nbins=cfg.nbins).cpu()
        ref = framewise_hist_pack_group(group.cpu(), p, nbins=cfg.nbins)
        # an empty frame's percentiles are NaN on both (inf * 0)
        same = (got == ref) | (got.isnan() & ref.isnan())
        assert bool(same.all()), (name, float((got - ref).abs().max()))
    log(f"histogram packs (mag/ang, rad/long) bit-equal to the CPU's on the "
        f"card's inputs ({time.perf_counter() - t0:.1f} s on the CPU)")

    # the row again, everything but the labelling on the CPU
    t0 = time.perf_counter()
    masked_cpu = masked.cpu()
    _, _, _, _, perc_hi = hist.calculate_3dhist(
        masked_cpu, nf, nbins=cfg.nbins, percentile=cfg.percentile)
    from tee_optical_flow_torch.signal.smoother import spectral_smooth

    filt_cpu = spectral_smooth(perc_hi, manager.peak_config.smooth_fraction,
                               manager.peak_config.pad_len)
    rad_c, lng_c = calculate_comp_magnitude(masked_cpu, cents)
    rl = hist._radlong_hists(rad_c, lng_c, nf, cfg.nbins, cfg.perc_lo,
                             cfg.perc_hi)
    traces_cpu = (rl["radial"][2], rl["radial"][3], rl["longitudinal"][2],
                  rl["longitudinal"][3])
    sec_cpu, _ = cohort._cohort_sections(ds, filt_cpu, traces_cpu, manager,
                                         proc)
    row_cpu = cohort._assemble_row(ds, sec_cpu)
    worst = 0.0
    for i, (g, r) in enumerate(zip(row, row_cpu)):
        if isinstance(r, (str, int, np.integer)) or r == 0:
            assert g == r, (i, g, r)
        elif r != g:
            rel = abs(g - r) / abs(r)
            worst = max(worst, rel)
            assert rel <= COHORT_ROW_RTOL, (i, g, r)
    log(f"config 4 row equal to the CPU's (floats within {worst:.3g} "
        f"relative, bound {COHORT_ROW_RTOL}; {time.perf_counter() - t0:.1f}"
        f" s on the CPU)")
    return dict(stages, launches=counts["tvl1_outer_loop"],
                wase_err_px=err, row=[v if isinstance(v, str) else float(v)
                                      for v in row], layout=layout)


def layout_of_file(path):
    """An HDF5 file as io/hdf5.optical_flow_layout's dict."""
    import h5py

    with h5py.File(path, "r") as f:
        return {k: (f[k][()], dict(f[k].attrs)) for k in f}


def saved_of_layout(layout):
    """check_schema's view of a layout."""
    attrs = layout["flow"][1]
    return dict(flow=layout["flow"][0], echo=layout["echo"][0],
                masks={k: layout[k][0] for k in attrs["labels"]},
                attrs=attrs)


def phase_cli(clip, workdir, has_h5py):
    """BASELINE config 5 on the card through the port's command line,
    cli.process.main: a folder of three synthetic 33x480x640 DICOMs at
    --nchunks 2 with a checkpoint directory (args.json and a
    checkpoint_best.pth of SAM_SEED's vit_t), their waveform folder and a
    PipelineConfig JSON (RVIO_2class, TV-L1 under the production config,
    saliency, WASE, waveforms, bfloat16). Where h5py is absent,
    main(_save_fn=...) captures what would be written.

    Checks: rc 0; the 2 + 1 split into chunk0/ and chunk1/; each clip's
    schema (the random-weight labels leave the flow bounds to the other
    paths) with its waveforms; 25 K1 calls per clip; the first clip's
    labels, masks, flow, echo and waveforms against a direct
    process_video call of the same DICOM with a segmentor loaded from the
    same checkpoint. Prints the CLI's seconds, each clip's (host clock to
    a synchronise; the second and third are the steady state), the stage
    report and load_segmentor's seconds."""
    import torch

    from tee_optical_flow_torch.cli import process as cli
    from tee_optical_flow_torch.config import DeviceConfig, PipelineConfig
    from tee_optical_flow_torch.flow import pipeline as pl
    from tee_optical_flow_torch.io.dicom_write import write_dicom_clip
    from tee_optical_flow_torch.io.hdf5 import optical_flow_layout
    from tee_optical_flow_torch.models import build_sam_vit_t
    from tee_optical_flow_torch.utils import get_stage_report

    n, h, w = clip.shape
    root = os.path.join(workdir, "config5")
    dcm_dir, wf_dir, ckpt, out = (os.path.join(root, d)
                                  for d in ("dcm", "wf", "run", "out"))
    for d in (dcm_dir, wf_dir, ckpt):
        os.makedirs(d)
    t0 = time.perf_counter()
    names = [f"{chr(ord('a') + i)}.dcm" for i in range(len(CLI_SEEDS))]
    for name, seed in zip(names, CLI_SEEDS):
        frames = clip if seed == 0 else echo_clip(n, h, w, seed=seed)[0]
        write_dicom_clip(os.path.join(dcm_dir, name),
                         np.repeat(frames[..., None], 3, axis=-1),
                         frame_rate=FPS, pixel_spacing=SPACING_CM)
        cohort_inputs(h, w, wf_dir, name[:-4])
    with open(os.path.join(ckpt, "args.json"), "w") as f:
        json.dump({"num_cls": SAM_CLASSES, "arch": "vit_t"}, f)
    torch.save(build_sam_vit_t(num_classes=SAM_CLASSES, seed=SAM_SEED,
                               device="cpu").state_dict(),
               os.path.join(ckpt, "checkpoint_best.pth"))
    cfg = PipelineConfig(mode="RVIO_2class", of_algo="tvl1",
                         no_saliency=False, wase=True,
                         include_waveforms=True,
                         device=DeviceConfig(model_dtype="bfloat16"))
    cfg_path = os.path.join(root, "pipeline.json")
    cfg.to_json(cfg_path)
    argv = ["--dcm_folder", dcm_dir, "--save_folder", out, "--nchunks",
            str(CLI_NCHUNKS), "--checkpoint_dir", ckpt, "--waveform_folder",
            wf_dir, "--config", cfg_path]
    log(f"--- config 5: python -m tee_optical_flow_torch.cli.process "
        f"{' '.join(argv)} (RVIO_2class, TVL1, saliency, WASE, waveforms, "
        f"bfloat16; {len(names)} DICOMs {n}x{h}x{w}, inputs written in "
        f"{time.perf_counter() - t0:.1f} s)")

    saved, clips, labels, load_s = {}, [], [], []

    def capture(save_path, flow_arr, echo_gray, mask_dict, metadata,
                waveforms, verbose=False, **kw):
        saved[save_path] = optical_flow_layout(
            flow_arr, echo_gray, mask_dict, metadata, waveforms, **kw)

    inner_video, inner_load = pl.process_video, cli.load_segmentor

    def timed_video(dcm_path, *args, **kw):
        before = read_counts()["tvl1_outer_loop"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner_video(dcm_path, *args, **kw)
        torch.cuda.synchronize()
        clips.append((os.path.basename(dcm_path), time.perf_counter() - t0,
                      read_counts()["tvl1_outer_loop"] - before))

    def timed_load(*args, **kw):
        t0 = time.perf_counter()
        seg = inner_load(*args, **kw)
        torch.cuda.synchronize()
        load_s.append(time.perf_counter() - t0)
        return record_labels(seg, labels)

    if not has_h5py:
        log("h5py is absent: cli.process.main(_save_fn=...) captures each "
            "clip's layout instead of writing it")
    get_stage_report(reset=True)
    reset_counts()
    with substituted(pl, "process_video", timed_video), \
            substituted(cli, "load_segmentor", timed_load):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(argv, _save_fn=None if has_h5py else capture)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    counts = read_counts()
    report = get_stage_report()
    log(f"config 5 CLI: rc {rc}, {cli_s:.3f} s for {len(names)} clips "
        f"(load_segmentor {load_s[0]:.3f} s); launches {counts}")
    for name, sec, k1 in clips:
        log(f"  clip {name}: {sec:.3f} s, {k1} K1 calls")
    log("  stages (host clock, s): " + ", ".join(
        f"{k} {v['total_s']:.3f} ({v['calls']}x)" for k, v in report.items()))
    assert rc == 0, rc
    assert [c[0] for c in clips] == names, clips
    assert all(c[2] == TV_LEVELS * TV_WARPS for c in clips), clips
    assert counts == dict(_NONE, tvl1_outer_loop=TV_LEVELS * TV_WARPS
                          * len(names),
                          connected_components=RVIO_LABELLINGS * len(names)), \
        counts
    chunks = np.array_split(np.asarray(names), CLI_NCHUNKS)
    expect = [os.path.join(out, f"chunk{i}", name[:-4] + ".hdf5")
              for i, part in enumerate(chunks) for name in part]
    if has_h5py:
        assert all(os.path.exists(p) for p in expect), expect
        saved = {p: layout_of_file(p) for p in expect}
    assert sorted(saved) == sorted(expect), sorted(saved)
    for path in expect:
        layout = saved[path]
        check_schema(saved_of_layout(layout), n, h, w, "RVIO_2class")
        attrs = layout["flow"][1]
        assert {"ecg", "art"} <= set(layout), sorted(layout)
        assert attrs["waveforms_present"] and not attrs["no_saliency"]
    log(f"config 5 outputs: {[os.path.relpath(p, out) for p in expect]}, "
        f"schema, waveforms and saliency flag checked")

    # the first clip again, straight through process_video
    direct, direct_labels = {}, []
    seg = record_labels(cli.load_segmentor(ckpt, model_dtype="bfloat16"),
                        direct_labels)
    pl.process_video(
        os.path.join(dcm_dir, names[0]), "direct.hdf5", seg, verbose=False,
        mode="RVIO_2class", bkgd_comp="WASE", no_saliency=False,
        OF_algo="TVL1", include_waveforms=True, waveform_folder=wf_dir,
        config=cfg.flow,
        _save_fn=lambda p, *a, verbose=False, **kw: direct.update(
            layout=optical_flow_layout(*a, **kw)))
    agree = float((labels[0] == direct_labels[0]).float().mean())
    log(f"config 5 first clip: labels of the CLI run and of a direct "
        f"process_video call agree on {agree:.6f} of "
        f"{labels[0].numel()} pixels")
    got, ref = saved[expect[0]], direct["layout"]
    assert sorted(got) == sorted(ref), (sorted(got), sorted(ref))
    if agree == 1.0:
        for key in ref:
            assert np.array_equal(got[key][0], ref[key][0]), key
        log("config 5 first clip: masks, flow, echo and waveforms "
            "bit-equal to the direct process_video call")
    else:
        diff = np.abs(got["flow"][0].astype(np.float32)
                      - ref["flow"][0].astype(np.float32))
        log(f"config 5 first clip: labels differ, flow max |CLI - direct| "
            f"{float(diff.max()):.3g} (WASE couples every pair to the "
            f"clip's whole background mask)")
        assert agree >= SAM_F32_AGREE, agree
    return dict(cli_s=cli_s, clip_s=[c[1] for c in clips],
                load_segmentor_s=load_s[0], labels_agree=agree,
                launches=counts["tvl1_outer_loop"],
                stages={k: v["total_s"] for k, v in report.items()})


def phase_peak_plots(layout):
    """The analysis entry points on the card, on the config-4 phase's dataset
    in memory: cli.peak_plots.analyze_clip under each of PEAK_METHODS
    with the radial/longitudinal data and the overlay arrays
    (--generate_videos, nbins 1000), api.analyze_optical_flow,
    api.analyze_radlong and api.detect_cardiac_cycle, and
    viz.manager.radlong_overlay_frames over the clip's frames, each
    timed to a synchronise.

    Held against their CPU recomputation: the packs, traces and the
    radial/longitudinal arrays bit-equal (the radial/longitudinal pass
    from the card's centroid track: the CPU labelling of the whole clip is
    too slow; the angle histogram from the card's angles: torch's atan2
    differs by an ulp between CUDA and the CPU), the raw AV centroid and
    the area series at COHORT_CENTROID_FRAMES, the cycles of every method
    equal lists (the host detection on the CPU from the card's area and
    angle-mode series; how many mode frames the CPU's own atan2 gives
    alike is printed), the overlay frames bit-equal when recomputed on the
    CPU from the card's arrays.
    No plot or video file is written: the card's machine has neither
    matplotlib nor imageio."""
    import torch

    from tee_optical_flow_torch import api
    from tee_optical_flow_torch.analysis import calculate_3dhist
    from tee_optical_flow_torch.analysis.components import (
        calculate_comp_magnitude,
    )
    from tee_optical_flow_torch.analysis.histograms import (
        _framewise_hist_and_percentiles, _radlong_hists, cart_to_polar,
    )
    from tee_optical_flow_torch.cli import peak_plots
    from tee_optical_flow_torch.dataset import OpticalFlowDataset
    from tee_optical_flow_torch.ops.morphology import (
        first_area_series, largest_centroid_series,
    )
    from tee_optical_flow_torch.signal import cycles
    from tee_optical_flow_torch.signal.smoother import spectral_smooth
    from tee_optical_flow_torch.viz.manager import radlong_overlay_frames

    ds = OpticalFlowDataset("echo_config4.hdf5", _file_override=layout)
    nf = ds.nframes
    log(f"--- analysis entry points on the config-4 dataset ({nf} frames, "
        f"labels {ds.accepted_labels}); no plot or video file is written "
        f"on the card (no matplotlib or imageio there): their arrays are "
        f"held against the CPU instead")
    parser = peak_plots.build_parser()
    secs, res = {}, {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t0
        return out

    for method in PEAK_METHODS:
        args = parser.parse_args(["echo_config4.hdf5", "--cc_method", method,
                                  "--generate_heatmaps", "--generate_videos"])
        res[method] = timed(f"analyze_clip_{method}_s",
                            lambda: peak_plots.analyze_clip(ds, args,
                                                            "cuda"))
        r = res[method]
        log(f"analyze_clip --cc_method {method}: {r['cc_method']} gating, "
            f"{len(r['sys_frames'])} systoles / {len(r['dia_frames'])} "
            f"diastoles, {secs[f'analyze_clip_{method}_s']:.3f} s")
    api_flow = timed("api_analyze_optical_flow_s",
                     lambda: api.analyze_optical_flow(ds, "velocity", "rv",
                                                      device="cuda"))
    api_rl = timed("api_analyze_radlong_s",
                   lambda: api.analyze_radlong(ds, "velocity",
                                               device="cuda"))
    api_cc = timed("api_detect_cardiac_cycle_s",
                   lambda: api.detect_cardiac_cycle(ds, "ecg_lazy",
                                                    device="cuda"))
    first = res[PEAK_METHODS[0]]
    echo = ds.get_echo()[:nf]
    frames = timed("overlay_s", lambda: radlong_overlay_frames(
        echo, first["rad_arr"], first["long_arr"], nf))
    assert frames.device == first["rad_arr"].device
    assert frames.dtype == torch.uint8
    assert tuple(frames.shape) == (nf, echo.shape[1], 2 * echo.shape[2], 3)
    log("analysis entry points on the card (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in secs.items()))

    # the CPU recomputation. torch's atan2 differs by an ulp between CUDA
    # and the CPU, so the angle histogram is recomputed on the CPU from
    # the card's angles (as phase_cohort's packs are); the magnitude, its
    # trace and the radial/longitudinal arrays from the CPU's own
    t0 = time.perf_counter()
    args = parser.parse_args(["echo_config4.hdf5"])
    label = first["label"]
    masked = ds.device_masked_arr(args.param, label, "cpu")
    mag, _, me, _, perc_hi = calculate_3dhist(
        masked, nf, nbins=args.nbins, percentile=args.percentile)
    filt = spectral_smooth(perc_hi, args.smooth_fraction, 20)
    ang_card = cart_to_polar(ds.device_masked_arr(args.param, label,
                                                  "cuda")[:nf])[1].cpu()
    ang_ulps = int((ang_card != cart_to_polar(masked[:nf])[1]).sum())
    ang, ae = _framewise_hist_and_percentiles(ang_card, nf, [50],
                                              args.nbins)[:2]
    cents = first["centroids"]
    rad, lng = calculate_comp_magnitude(masked, cents)
    radlong = _radlong_hists(rad, lng, nf, args.nbins, 1, 99)

    def same(a, b):
        if isinstance(a, dict):
            return sorted(a) == sorted(b) and all(same(a[k], b[k])
                                                  for k in a)
        if isinstance(a, (tuple, list)):
            return len(a) == len(b) and all(map(same, a, b))
        if isinstance(a, torch.Tensor):
            a, b = a.cpu(), torch.as_tensor(b).cpu()
            return bool(torch.equal(a, b))
        return np.array_equal(np.asarray(a), np.asarray(b))

    for method, r in res.items():
        for key, ref in (("mag", mag), ("ang", ang), ("mag_edges", me),
                         ("ang_edges", ae), ("perc_hi", perc_hi),
                         ("filt", filt), ("centroids", cents),
                         ("radlong", radlong), ("rad_arr", rad),
                         ("long_arr", lng)):
            assert same(r[key], ref), (method, key)
    assert same(api_flow, {"magnitude": mag, "angle": ang,
                           "magnitude_edges": me, "angle_edges": ae,
                           "percentile_high": perc_hi})
    assert same(api_rl, radlong)
    log(f"packs, traces and radial/longitudinal arrays of every analysis "
        f"call bit-equal to the CPU's ({time.perf_counter() - t0:.1f} s on "
        f"the CPU; radial/longitudinal from the card's centroid track, the "
        f"angle histogram from the card's angles: {ang_ulps} of "
        f"{ang_card.numel()} atan2 values differ from the CPU's)")

    # the per-frame labellings at a few frames, then the cycles
    t0 = time.perf_counter()
    picks = list(COHORT_CENTROID_FRAMES)
    av = torch.from_numpy(np.ascontiguousarray(
        ds.get_mask("av")[:nf, :, :, 0].astype(bool)))
    rv = torch.from_numpy(np.ascontiguousarray(
        ds.get_mask(first["cc_label"])[:nf, :, :, 0].astype(bool)))
    for name, fn, masks in (("AV centroid", largest_centroid_series, av),
                            ("area", first_area_series, rv)):
        card = fn(masks.cuda())
        cpu = fn(masks[picks])
        for a, b in zip(card, cpu):
            assert torch.equal(a[picks].cpu(), b), (name, a[picks], b)
        if name == "area":
            areas = [t.cpu() for t in card]
    log(f"AV centroid and {first['cc_label']} area series at frames {picks} "
        f"equal on the card and the CPU ({time.perf_counter() - t0:.1f} s "
        f"of CPU labelling)")
    t0 = time.perf_counter()

    def card_areas(frames):
        assert tuple(frames.shape) == tuple(rv.shape), frames.shape
        return tuple(areas)

    # the angle detector's per-frame mode of the rounded angles, on the
    # card and the CPU: atan2's ulp can move a value across a bucket edge
    modes = cycles.angle_mode_series(
        ds.device_masked_arr(args.param, first["cc_label"], "cuda")[:nf]
    ).cpu()
    modes_cpu = cycles.angle_mode_series(ds.device_masked_arr(
        args.param, first["cc_label"], "cpu")[:nf])
    log(f"angle mode series: {int((modes == modes_cpu).sum())} of {nf} "
        f"frames equal on the card and the CPU (max difference "
        f"{float((modes - modes_cpu).abs().max()):.3g} rad)")

    def card_modes(flow):
        assert tuple(flow.shape[:3]) == tuple(rv.shape), flow.shape
        return modes

    with substituted(cycles, "first_area_series", card_areas), \
            substituted(cycles, "angle_mode_series", card_modes):
        for method, r in res.items():
            ref = api.detect_cardiac_cycle(ds, r["cc_method"], args.param,
                                           r["cc_label"], device="cpu")
            assert same(list(ref), [r["sys_frames"], r["dia_frames"]]), \
                (method, ref, r["sys_frames"], r["dia_frames"])
    assert same(list(api_cc), [res["ecg_lazy"]["sys_frames"],
                               res["ecg_lazy"]["dia_frames"]])
    log(f"cycles of {list(res)} equal to the CPU's "
        f"({time.perf_counter() - t0:.1f} s on the CPU; the area and angle "
        f"detectors from the card's per-frame series)")

    t0 = time.perf_counter()
    ref = radlong_overlay_frames(echo, first["rad_arr"].cpu(),
                                 first["long_arr"].cpu(), nf)
    got = frames.cpu()
    differ = int((got != ref).any(dim=-1).sum())
    log(f"overlay frames {tuple(got.shape)} on the card against the CPU from "
        f"the card's arrays: {differ} pixels differ (bound 0; "
        f"{time.perf_counter() - t0:.1f} s on the CPU)")
    assert differ == 0, differ
    return dict(secs, cycles={m: [len(r["sys_frames"]), len(r["dia_frames"])]
                              for m, r in res.items()})


def train_inputs(clip, folder, frames, name):
    """A CSV list ``<name>.csv`` of ``frames`` of ``clip`` in ``folder``,
    written as PNGs with PIL: each frame as RGB under img/, the geometry
    labels (geometry_labels) once under mask/ for every row."""
    from PIL import Image

    h, w = clip.shape[1:]
    for d in ("img", "mask"):
        os.makedirs(os.path.join(folder, d), exist_ok=True)
    Image.fromarray(geometry_labels(h, w)).save(
        os.path.join(folder, "mask", "labels.png"))
    rows = []
    for k in frames:
        Image.fromarray(np.repeat(clip[k][..., None], 3, axis=-1)).save(
            os.path.join(folder, "img", f"{k}.png"), compress_level=1)
        rows.append(f"{k}.png,labels.png")
    path = os.path.join(folder, f"{name}.csv")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return path


def _event_ms(fn):
    """fn() timed with CUDA events (no synchronise inside)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    return start, end


def _median_step_ms(step, state, batches, warm, timed):
    """Median ms per train step over ``timed`` steps after ``warm``."""
    import torch

    for k in range(warm):
        step(state, *batches[k % len(batches)])
    events = [_event_ms(lambda k=k: step(state, *batches[k % len(batches)]))
              for k in range(timed)]
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def conv_backward_flop(grad_out_shape, x_shape, w_shape, bias, stride,
                       padding, dilation, transposed, output_padding, groups,
                       output_mask, out_shape=None, **kw):
    """FLOPs of aten.convolution_backward for FlopCounterMode: the input
    gradient and the weight gradient each cost what the forward
    convolution costs (2 x batch x the weight's elements x the output's
    positions; a transposed convolution's positions are its input's).
    torch's own formula counts the weight gradient of a grouped
    (depthwise) convolution as if it were dense."""
    spatial = (x_shape if transposed else grad_out_shape)[2:]
    one = 2 * grad_out_shape[0] * int(np.prod(w_shape)) * int(np.prod(spatial))
    return one * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def _train_runtime(steps, device="cuda", **kw):
    from tee_optical_flow_torch.config import TrainConfig
    from tee_optical_flow_torch.train import loop

    cfg = TrainConfig(num_cls=SAM_CLASSES, image_size=TRAIN_SIZE,
                      out_size=TRAIN_OUT, b=TRAIN_BATCH, lr=TRAIN_LR,
                      weight_decay=TRAIN_WD, epochs=1, **kw)
    return loop.build_runtime(cfg, steps, device=device)


def phase_train(clip, workdir, has_h5py):
    """SAM vit_t fine-tuning on the card at full width (see TRAIN_*):
    step time, memory, FLOPs and precision; the overfit check; the
    adapter and LoRA policies; one step card against CPU; and cli.train
    -> load_segmentor -> cli.process. No CUDA kernel of this repository
    lies on the training path: its launch counts must stay 0 there."""
    import copy

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from tee_optical_flow_torch.cli import process as cli_process
    from tee_optical_flow_torch.cli import train as cli_train
    from tee_optical_flow_torch.io.dicom_write import write_dicom_clip
    from tee_optical_flow_torch.models import (
        build_sam_vit_t, make_clip_segmentor,
    )
    from tee_optical_flow_torch.models.lora import init_lora
    from tee_optical_flow_torch.train import checkpoint as ckpt_mod
    from tee_optical_flow_torch.train import loop
    from tee_optical_flow_torch.train.data import (
        PublicDataset, batch_iterator,
    )
    from tee_optical_flow_torch.train.losses import dice_coeff_multi_class

    assert not (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)
    root = os.path.join(workdir, "train")
    n = clip.shape[0]
    lst = train_inputs(clip, root, range(n), "all")
    t0 = time.perf_counter()
    ds = PublicDataset(os.path.join(root, "img"), os.path.join(root, "mask"),
                       lst, phase="train", image_size=TRAIN_SIZE,
                       out_size=TRAIN_OUT, seed=TRAIN_SEED)
    batches = list(batch_iterator(ds, TRAIN_BATCH, seed=TRAIN_SEED))
    data_s = time.perf_counter() - t0
    images, labels = batches[0]
    assert images.shape == (TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3), \
        images.shape
    assert labels.shape == (TRAIN_BATCH, TRAIN_OUT, TRAIN_OUT), labels.shape
    shares = np.bincount(labels.ravel(), minlength=SAM_CLASSES) / labels.size
    log(f"--- training: vit_t {TRAIN_SIZE} -> {TRAIN_OUT}, {SAM_CLASSES} "
        f"classes, batch "
        f"{TRAIN_BATCH}, {len(batches)} batches of the {n}-frame clip with "
        f"geometry labels (class shares {np.round(shares, 4).tolist()}), "
        f"PNGs read, resized and augmented by PublicDataset in "
        f"{data_s:.1f} s")

    # step time, memory, FLOPs (vanilla, encoder updated)
    model = build_sam_vit_t(num_classes=SAM_CLASSES, image_size=TRAIN_SIZE,
                            seed=TRAIN_SEED)
    init, step = loop.make_train_step(
        model, _train_runtime(TRAIN_WARM + TRAIN_TIMED))
    state = init()
    n_train = sum(t.numel() for _, t in state.trainable)
    with FlopCounterMode(display=False, custom_mapping={
            torch.ops.aten.convolution_backward: conv_backward_flop}) as counter:
        step.loss_and_grads(state, images, labels)
    flops = counter.get_total_flops()
    by_op = {str(k).split(".")[-1]: v / 1e9
             for k, v in counter.get_flop_counts()["Global"].items()}
    reset_counts()
    timing = {}
    try:
        for tag, tf32, peak in (("f32", False, FP32_OPS_PER_S),
                                ("tf32", True, TF32_DENSE_OPS_PER_S)):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = _median_step_ms(step, state, batches, TRAIN_WARM,
                                 TRAIN_TIMED)
            rate = flops / (ms * 1e-3)
            timing[tag] = dict(
                ms_per_step=ms, images_per_s=TRAIN_BATCH / (ms * 1e-3),
                tflop_per_s=rate / 1e12, share_of_peak=rate / peak,
                max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
            log(f"train step ({tag}: convolutions and products in "
                f"{'TF32' if tf32 else 'float32'}), batch {TRAIN_BATCH}: "
                f"median {ms:.3f} ms over {TRAIN_TIMED} steps after "
                f"{TRAIN_WARM}, {timing[tag]['images_per_s']:.1f} images/s, "
                f"{flops / 1e9:.1f} GFLOP per step -> {rate / 1e12:.2f} "
                f"TFLOP/s = {100 * rate / peak:.2f}% of the "
                f"{peak / 1e12:.0f} TFLOP/s peak; max memory allocated "
                f"{timing[tag]['max_memory_gb']:.2f} GB")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    log("train steps, 3 in float32 under torch.profiler (the device's busy "
        "share of their wall time, the kernels that take it):")
    profile_clip(lambda: [step(state, *batches[k]) for k in range(3)])
    counts = read_counts()
    assert counts == _NONE, counts
    log(f"train step FLOPs by operation (GFLOP, forward and backward; "
        f"FlopCounterMode with the grouped-convolution backward counted as "
        f"conv_backward_flop does): "
        + ", ".join(f"{k} {v:.1f}" for k, v in by_op.items()))
    log(f"train: {n_train} trainable parameters; launches of this repo's "
        f"kernels over the timed steps {counts} (none on the training "
        f"path)")
    del model, state, step

    # overfit one batch at a constant lr
    model = build_sam_vit_t(num_classes=SAM_CLASSES, image_size=TRAIN_SIZE,
                            seed=TRAIN_SEED)
    init, step = loop.make_train_step(
        model, _train_runtime(TRAIN_OVERFIT_STEPS, warmup=False))
    state = init()
    losses = [float(step(state, images, labels)["total_loss"])
              for _ in range(TRAIN_OVERFIT_STEPS)]
    log(f"overfit, {TRAIN_OVERFIT_STEPS} steps on one batch at lr "
        f"{TRAIN_LR}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(ratio {losses[-1] / losses[0]:.3f}, bound "
        f"{TRAIN_OVERFIT_RATIO}); every 5th: "
        f"{[round(v, 4) for v in losses[::5]]}")
    assert all(np.isfinite(losses)), losses
    assert losses[-1] <= TRAIN_OVERFIT_RATIO * losses[0], losses
    overfit = dict(first=losses[0], last=losses[-1])
    del model, state, step

    # the other policies
    peft = {}
    for policy in ("adapter", "lora"):
        build = (dict(adapter_stages=(1, 2, 3), use_decoder_adapter=True)
                 if policy == "adapter" else {})
        model = build_sam_vit_t(num_classes=SAM_CLASSES,
                                image_size=TRAIN_SIZE, seed=TRAIN_SEED,
                                **build)
        init, step = loop.make_train_step(
            model, _train_runtime(TRAIN_WARM + TRAIN_PEFT_STEPS),
            finetune_type=policy)
        state = init(init_lora(model, rank=4, seed=TRAIN_SEED)
                     if policy == "lora" else None)
        n_p = sum(t.numel() for _, t in state.trainable)
        ms = _median_step_ms(step, state, batches, TRAIN_WARM,
                             TRAIN_PEFT_STEPS)
        peft[policy] = dict(ms_per_step=ms, trainable=n_p)
        log(f"train {policy} (encoder and decoder): {n_p} trainable "
            f"parameters, median {ms:.3f} ms per step over "
            f"{TRAIN_PEFT_STEPS} steps after {TRAIN_WARM} (float32)")
        del model, state, step

    # one step, card against CPU, strict float32
    x1, y1 = images[:1], labels[:1]
    grads, losses = {}, {}
    for key, dev in (("cpu", "cpu"), ("card", "cuda")):
        model = build_sam_vit_t(num_classes=SAM_CLASSES,
                                image_size=TRAIN_SIZE, seed=TRAIN_SEED,
                                device=dev)
        rt = _train_runtime(1, device=dev)
        init, step = loop.make_train_step(model, rt)
        state = init()
        t0 = time.perf_counter()
        metrics, g = step.loss_and_grads(state, x1, y1)
        losses[key] = float(metrics["total_loss"])
        grads[key] = {k: v.cpu() for k, v in g.items()}
        if key == "cpu":
            cpu_s = time.perf_counter() - t0
        else:
            dsc = loop.make_eval_step(model, rt, SAM_CLASSES)(state, x1,
                                                              y1)[1]
            with torch.no_grad():
                xd = torch.from_numpy(x1).cuda().permute(0, 3, 1, 2)
                logits = model(xd.contiguous())[0]
            yd = torch.from_numpy(y1).long()
            dsc_card = dice_coeff_multi_class(logits.argmax(1), yd.cuda(),
                                              SAM_CLASSES)
            dsc_cpu = dice_coeff_multi_class(logits.cpu().argmax(1), yd,
                                             SAM_CLASSES)
        del model, state, step
    assert sorted(grads["cpu"]) == sorted(grads["card"])
    gmax = max(float(v.abs().max()) for v in grads["cpu"].values())
    worst, noise = 0.0, []
    for name, ref in grads["cpu"].items():
        got = grads["card"][name]
        scale = float(ref.abs().max())
        if scale < TRAIN_GRAD_NOISE * gmax:
            noise.append(name)
            assert float(got.abs().max()) < TRAIN_GRAD_NOISE * gmax, name
            continue
        rel = float((got - ref).abs().max()) / scale
        worst = max(worst, rel)
        assert rel <= TRAIN_GRAD_REL, (name, rel)
    loss_rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    log(f"train step card vs CPU, batch 1 at {TRAIN_SIZE}, strict "
        f"float32: loss "
        f"{losses['card']:.7f} vs {losses['cpu']:.7f} (rel {loss_rel:.3g}, "
        f"bound {TRAIN_LOSS_REL}); {len(grads['cpu'])} gradients, worst "
        f"max-abs error {worst:.3g} of the tensor's max-abs (bound "
        f"{TRAIN_GRAD_REL}), {len(noise)} zero-in-exact-arithmetic tensors "
        f"under {TRAIN_GRAD_NOISE} x the largest gradient; eval DSC "
        f"{float(dsc):.6f}, recomputed on the CPU from the card's logits "
        f"{float(dsc_cpu):.6f}; CPU step {cpu_s:.1f} s")
    assert loss_rel <= TRAIN_LOSS_REL, losses
    assert float(dsc) == float(dsc_card) == float(dsc_cpu), \
        (float(dsc), float(dsc_card), float(dsc_cpu))

    # cli.train -> checkpoint_best.pth -> load_segmentor -> cli.process
    n_tr, n_val = TRAIN_CLI_FRAMES
    tr_list = train_inputs(clip, root, range(n_tr), "train")
    val_list = train_inputs(clip, root, range(n_tr, n_tr + n_val), "val")
    run = os.path.join(root, "run")
    argv = ["--dir_checkpoint", run, "--img_folder",
            os.path.join(root, "img"), "--mask_folder",
            os.path.join(root, "mask"), "--train_img_list", tr_list,
            "--val_img_list", val_list, "--num_cls", str(SAM_CLASSES),
            "--epochs", str(TRAIN_CLI_EPOCHS), "-b", str(TRAIN_BATCH),
            "--lr", str(TRAIN_LR), "--warmup_period", "2", "--seed",
            str(TRAIN_SEED), "--image_size", str(TRAIN_SIZE), "--out_size",
            str(TRAIN_OUT), "--device", "cuda"]
    saved = []
    inner_save = ckpt_mod.save_checkpoint

    def keep_copy(dir_checkpoint, model, *args, **kw):
        saved.append(copy.deepcopy(model))
        return inner_save(dir_checkpoint, model, *args, **kw)

    t0 = time.perf_counter()
    with substituted(ckpt_mod, "save_checkpoint", keep_copy):
        rc = cli_train.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    assert rc == 0 and saved, (rc, len(saved))
    files = sorted(os.listdir(run))
    assert {"args.json", "checkpoint_best.pth"} <= set(files), files
    log(f"cli.train {' '.join(argv[-20:])}: rc {rc} in {train_s:.1f} s, "
        f"{len(saved)} best-DSC checkpoint(s); {run} holds {files}")
    t0 = time.perf_counter()
    served = cli_process.load_segmentor(run, model_dtype="float32")
    clip_dev = torch.from_numpy(np.ascontiguousarray(clip)).cuda()
    got = served.labels_device(clip_dev, clip.shape[1:])
    ref = make_clip_segmentor(saved[-1]).labels_device(clip_dev,
                                                       clip.shape[1:])
    torch.cuda.synchronize()
    agree = float((got == ref).float().mean())
    log(f"load_segmentor({run}) against the trained model in memory: "
        f"{agree:.6f} of the {n}-frame clip's labels equal "
        f"({time.perf_counter() - t0:.1f} s)")
    assert agree == 1.0, agree

    dcm_dir, out = os.path.join(root, "dcm"), os.path.join(root, "out")
    os.makedirs(dcm_dir)
    write_dicom_clip(os.path.join(dcm_dir, "trained.dcm"),
                     np.repeat(clip[..., None], 3, axis=-1),
                     frame_rate=FPS, pixel_spacing=SPACING_CM)
    layouts = {}

    def capture(save_path, flow_arr, echo_gray, mask_dict, metadata,
                waveforms, verbose=False, **kw):
        from tee_optical_flow_torch.io.hdf5 import optical_flow_layout

        layouts[save_path] = optical_flow_layout(
            flow_arr, echo_gray, mask_dict, metadata, waveforms, **kw)

    reset_counts()
    t0 = time.perf_counter()
    rc = cli_process.main(
        ["--dcm_folder", dcm_dir, "--save_folder", out, "--checkpoint_dir",
         run, "--mode", "RVIO_2class"],
        _save_fn=None if has_h5py else capture)
    torch.cuda.synchronize()
    process_s = time.perf_counter() - t0
    counts = read_counts()
    log(f"cli.process --checkpoint_dir {run} --mode RVIO_2class on one "
        f"{n}x{clip.shape[1]}x{clip.shape[2]} DICOM: rc {rc} in "
        f"{process_s:.1f} s; launches {counts}")
    assert rc == 0, rc
    assert counts == dict(_NONE, tvl1_outer_loop=TV_LEVELS * TV_WARPS,
                          connected_components=RVIO_LABELLINGS), counts
    if not has_h5py:
        (layout,) = layouts.values()
        check_schema(saved_of_layout(layout), n, *clip.shape[1:],
                     "RVIO_2class")
    return dict(step=timing, gflop_per_step=flops / 1e9, gflop_by_op=by_op,
                trainable=n_train, overfit=overfit, peft=peft,
                card_vs_cpu=dict(loss_rel=loss_rel, worst_grad_rel=worst,
                                 noise_tensors=len(noise), dsc=float(dsc)),
                cli_train_s=train_s, cli_process_s=process_s,
                serve_agree=agree, data_s=data_s)


MESH_STEPS, MESH_TIMED = 3, 3
MESH_STATS_REL, MESH_DSC_ABS = 1e-5, 1e-3


def _mesh_compare(tag, got, ref, steps):
    """A mesh run's rank-0 results against the one-process run's (see
    phase_train_mesh); returns the worst errors."""
    losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"][:steps],
                                                  ref["losses"][:steps])]
    assert max(losses) <= TRAIN_LOSS_REL, (tag, got["losses"],
                                           ref["losses"])
    assert sorted(got["grads"]) == sorted(ref["grads"]), tag
    gmax = max(float(v.abs().max()) for v in ref["grads"].values())
    worst, noise = 0.0, 0
    for name, r in ref["grads"].items():
        g = got["grads"][name]
        scale = float(r.abs().max())
        if scale < TRAIN_GRAD_NOISE * gmax:
            noise += 1
            assert float(g.abs().max()) < TRAIN_GRAD_NOISE * gmax, (tag,
                                                                    name)
            continue
        rel = float((g - r).abs().max()) / scale
        worst = max(worst, rel)
        assert rel <= TRAIN_GRAD_REL, (tag, name, rel)
    stats = 0.0
    for kind in ("running_mean", "running_var"):
        keys = [k for k in ref["stats"] if k.endswith(kind)]
        top = max(float(ref["stats"][k].abs().max()) for k in keys)
        for k in keys:
            err = float((got["stats"][k] - ref["stats"][k]).abs().max())
            stats = max(stats, err / top)
    assert stats <= MESH_STATS_REL, (tag, stats)
    eval_rel = abs(got["eval"][0] - ref["eval"][0]) / abs(ref["eval"][0])
    dsc_err = abs(got["eval"][1] - ref["eval"][1])
    assert eval_rel <= TRAIN_LOSS_REL and dsc_err <= MESH_DSC_ABS, (
        tag, got["eval"], ref["eval"])
    return dict(loss_rel=max(losses), grad_rel=worst, noise_tensors=noise,
                stats_rel=stats, eval_loss_rel=eval_rel, dsc_abs=dsc_err,
                n_stats=len(ref["stats"]) // 2)


def _mesh_record(tag, res, ref):
    """Backend, ms per step, bytes and host seconds of the all-reduces of
    one step, batch-norm all-reduces per step and each rank's peak
    memory, logged beside the card."""
    r0 = res[0]
    tally = r0["tally"]
    moved = sum(v["bytes"] for v in tally.values())
    secs = sum(v["seconds"] for v in tally.values())
    rec = dict(backend=r0["backend"], ranks=len(res), ms_per_step=r0["ms"],
               one_process_ms=ref["ms"],
               bytes_all_reduced=moved, all_reduce_s=secs,
               all_reduce_calls=sum(v["calls"] for v in tally.values()),
               grad_bytes=tally["grads"]["bytes"],
               grad_all_reduce_s=tally["grads"]["seconds"],
               batchnorm_all_reduces=tally["sum"]["calls"],
               model_axis_all_reduces=sum(tally[k]["calls"] for k in
                                          ("copy", "reduce", "gather")),
               max_memory_gb=[r["max_memory_gb"] for r in res],
               one_process_max_memory_gb=ref["max_memory_gb"])
    log(f"train mesh {tag}: {rec['ranks']} ranks on one card over "
        f"{rec['backend']}; {rec['ms_per_step']:.3f} ms per step (median of "
        f"{MESH_TIMED}, CUDA events, rank 0) against {ref['ms']:.3f} ms in "
        f"one process; one step all-reduces {moved / 1e6:.3f} MB in "
        f"{rec['all_reduce_calls']} calls, {secs * 1e3:.3f} ms of host "
        f"time ({tally['grads']['bytes'] / 1e6:.3f} MB of gradients in "
        f"{tally['grads']['seconds'] * 1e3:.3f} ms; "
        f"{rec['batchnorm_all_reduces']} batch-norm all-reduces, "
        f"{rec['model_axis_all_reduces']} of the model axis); peak memory "
        f"per rank {[round(m, 3) for m in rec['max_memory_gb']]} GB "
        f"(one process {ref['max_memory_gb']:.3f} GB)")
    return rec


def train_serve_rank(argv, entries, clip_path, labels_path):
    """One rank of cli.train (phase_train_mesh (d)), TF32 off: rank 0
    also writes, when it saves checkpoint_best.pth, the labels that the
    model it holds gives the clip at ``clip_path``."""
    import torch

    from tee_optical_flow_torch.cli import train as cli_train
    from tee_optical_flow_torch.models import make_clip_segmentor
    from tee_optical_flow_torch.train import checkpoint as ckpt_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inner = ckpt_mod.save_checkpoint

    def keep_labels(dir_checkpoint, model, *args, **kw):
        clip = np.load(clip_path)
        clip_dev = torch.from_numpy(clip).to(next(model.parameters()).device)
        labels = make_clip_segmentor(model).labels_device(clip_dev,
                                                          clip.shape[1:])
        torch.save(labels.cpu(), labels_path)
        return inner(dir_checkpoint, model, *args, **kw)

    with substituted(ckpt_mod, "save_checkpoint", keep_labels):
        return cli_train.main(argv, entries)


def phase_train_mesh(clip, workdir, has_h5py):
    """SAM vit_t fine-tuning on a ('data', 'model') mesh of processes, the
    card named once per rank (gloo; nccl refuses two ranks on one card),
    at full width (TRAIN_SIZE -> TRAIN_OUT, SAM_CLASSES classes, vanilla,
    float32 with TF32 off, global batch TRAIN_BATCH), each run held to
    the one-process run on the same batches (train/mesh_steps.run_steps
    on both sides):

      (a) data axis 2: 2 ranks, MESH_STEPS steps: each step's loss, one
          step's gradients, the 27 batch norms' running statistics, the
          eval loss and DSC;
      (b) model axis 2 with sam_param_shardings: 2 ranks, 1 step;
      (c) 2x2 with sam_param_shardings: 4 ranks, 1 step;
      (d) cli.train's launcher (cli.train.main with the card named twice):
          2 ranks, one epoch on PNGs of the clip; load_segmentor serves
          rank 0's checkpoint_best.pth, whose labels of the clip equal the
          ones the trained model gave in rank 0, and cli.process serves it
          (25 K1 calls);
      (e) cli.train --data_axis 2 on the one card raises ShardingError.

    Records the backend, ms per step (CUDA events) 1 process against 2
    and 4 ranks, the bytes all-reduced per step and their host time, the
    batch-norm all-reduces per step and each rank's peak memory. The 2 and
    4 ranks share one card: this measures the cost of the split, not a
    speed-up."""
    import torch

    from tee_optical_flow_torch.cli import process as cli_process
    from tee_optical_flow_torch.cli import train as cli_train
    from tee_optical_flow_torch.exceptions import ShardingError
    from tee_optical_flow_torch.io.dicom_write import write_dicom_clip
    from tee_optical_flow_torch.models import build_sam_vit_t
    from tee_optical_flow_torch.parallel.launch import launch
    from tee_optical_flow_torch.train.data import (
        PublicDataset, batch_iterator,
    )
    from tee_optical_flow_torch.train.mesh_steps import run_steps

    root = os.path.join(workdir, "train_mesh")
    n = clip.shape[0]
    lst = train_inputs(clip, root, range(n), "all")
    ds = PublicDataset(os.path.join(root, "img"), os.path.join(root, "mask"),
                       lst, phase="train", image_size=TRAIN_SIZE,
                       out_size=TRAIN_OUT, seed=TRAIN_SEED)
    batches = list(batch_iterator(ds, TRAIN_BATCH, seed=TRAIN_SEED))
    batches = batches[:MESH_STEPS]
    weights = os.path.join(root, "weights.pt")
    data = os.path.join(root, "batches.pt")
    model = build_sam_vit_t(num_classes=SAM_CLASSES, image_size=TRAIN_SIZE,
                            seed=TRAIN_SEED, device="cpu")
    torch.save({"model": model.state_dict(), "lora": None}, weights)
    torch.save({"train": [(x, y, None) for x, y in batches],
                "eval": batches[0]}, data)
    del model
    cfg = dict(num_cls=SAM_CLASSES, image_size=TRAIN_SIZE,
               out_size=TRAIN_OUT, b=TRAIN_BATCH, lr=TRAIN_LR,
               weight_decay=TRAIN_WD, epochs=1)

    def spec(mesh, shard, steps):
        k = mesh[0] * mesh[1]
        return dict(model={"arch": "vit_t", "num_classes": SAM_CLASSES,
                           "image_size": TRAIN_SIZE, "seed": TRAIN_SEED},
                    weights=weights, batches=data, cfg=cfg,
                    policy={"finetune_type": "vanilla"}, mesh=mesh,
                    devices=["cuda:0"] * k, shard=shard, steps=steps,
                    timed=MESH_TIMED, light=True)

    out, refs = {}, {}
    for steps in (MESH_STEPS, 1):
        t0 = time.perf_counter()
        ref = refs[steps] = run_steps([spec((1, 1), False, steps)])[0]
        torch.cuda.empty_cache()
        log(f"train mesh: one process, {steps} step(s): losses "
            f"{[round(v, 6) for v in ref['losses']]}, eval {ref['eval']}, "
            f"{ref['ms']:.3f} ms per step, {ref['batchnorms']} batch norms "
            f"({time.perf_counter() - t0:.1f} s)")
        assert ref["batchnorms"] == 27, ref["batchnorms"]
    # one launch per world size: (a) and (b) share the 2 ranks
    runs = (("a: data 2", (2, 1), False, MESH_STEPS),
            ("b: model 2", (1, 2), True, 1), ("c: 2x2", (2, 2), True, 1))
    results = {}
    for world in (2, 4):
        t0 = time.perf_counter()
        mine = [r for r in runs if r[1][0] * r[1][1] == world]
        ranks = launch(run_steps, ([spec(mesh, shard, steps)
                                    for _, mesh, shard, steps in mine],),
                       devices=["cuda:0"] * world, timeout=600)
        for i, run in enumerate(mine):
            results[run[0]] = [r[i] for r in ranks]
        log(f"train mesh: {world} ranks ran {[r[0] for r in mine]} in "
            f"{time.perf_counter() - t0:.1f} s")
    for tag, mesh, shard, steps in runs:
        res = results[tag]
        assert all(r["backend"] == "gloo" for r in res), tag
        assert res[0]["cross_replica"] == (27 if mesh[0] > 1 else 0), tag
        assert bool(res[0]["split"]) == shard, tag
        for r in res[1:]:
            for name, g in res[0]["grads"].items():
                assert torch.equal(r["grads"][name], g), (tag, name)
            for name, v in res[0]["stats"].items():
                assert torch.equal(r["stats"][name], v), (tag, name)
            assert r["losses"] == res[0]["losses"], tag
        err = _mesh_compare(tag, res[0], refs[steps], steps)
        rec = _mesh_record(tag, res, refs[steps])
        log(f"train mesh {tag} against one process ({steps} step(s)): "
            f"{json.dumps(err)}; {len(res[0]['split'])} tensors split")
        out[tag] = dict(err, **rec)

    # (d) cli.train's launcher -> checkpoint_best.pth -> load_segmentor,
    # cli.process
    t0 = time.perf_counter()
    n_tr, n_val = TRAIN_CLI_FRAMES
    tr_list = train_inputs(clip, root, range(n_tr), "train")
    val_list = train_inputs(clip, root, range(n_tr, n_tr + n_val), "val")
    run = os.path.join(root, "run")
    argv = ["--dir_checkpoint", run, "--img_folder",
            os.path.join(root, "img"), "--mask_folder",
            os.path.join(root, "mask"), "--train_img_list", tr_list,
            "--val_img_list", val_list, "--num_cls", str(SAM_CLASSES),
            "--epochs", "1", "-b", str(TRAIN_BATCH), "--lr", str(TRAIN_LR),
            "--warmup_period", "2", "--seed", str(TRAIN_SEED),
            "--image_size", str(TRAIN_SIZE), "--out_size", str(TRAIN_OUT),
            "--data_axis", "2", "--device", "cuda"]
    clip_path = os.path.join(root, "clip.npy")
    labels_path = os.path.join(root, "trained_labels.pt")
    np.save(clip_path, clip)
    entries = ["cuda:0"] * 2
    rcs = launch(train_serve_rank, (argv, entries, clip_path, labels_path),
                 devices=entries, timeout=600)
    train_s = time.perf_counter() - t0
    files = sorted(os.listdir(run))
    assert rcs == [0, 0] and {"args.json", "checkpoint_best.pth"} <= set(
        files), (rcs, files)
    trained = torch.load(labels_path)
    served = cli_process.load_segmentor(run, model_dtype="float32")
    clip_dev = torch.from_numpy(np.ascontiguousarray(clip)).cuda()
    got = served.labels_device(clip_dev, clip.shape[1:]).cpu()
    agree = float((got == trained).float().mean())
    log(f"train mesh d: cli.train {' '.join(argv[-6:])} on 2 ranks of the "
        f"card: rc {rcs} in {train_s:.1f} s; {run} holds {files}; "
        f"load_segmentor's labels of the {n}-frame clip against the ones "
        f"the trained model gave in rank 0: {agree:.6f} equal")
    assert agree == 1.0, agree
    dcm_dir, save = os.path.join(root, "dcm"), os.path.join(root, "out")
    os.makedirs(dcm_dir)
    write_dicom_clip(os.path.join(dcm_dir, "trained.dcm"),
                     np.repeat(clip[..., None], 3, axis=-1),
                     frame_rate=FPS, pixel_spacing=SPACING_CM)
    layouts = {}

    def capture(save_path, flow_arr, echo_gray, mask_dict, metadata,
                waveforms, verbose=False, **kw):
        from tee_optical_flow_torch.io.hdf5 import optical_flow_layout

        layouts[save_path] = optical_flow_layout(
            flow_arr, echo_gray, mask_dict, metadata, waveforms, **kw)

    reset_counts()
    t1 = time.perf_counter()
    rc = cli_process.main(
        ["--dcm_folder", dcm_dir, "--save_folder", save, "--checkpoint_dir",
         run, "--mode", "RVIO_2class"],
        _save_fn=None if has_h5py else capture)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"train mesh d: cli.process --checkpoint_dir {run} --mode "
        f"RVIO_2class: rc {rc} in {time.perf_counter() - t1:.1f} s; "
        f"launches {counts}")
    assert rc == 0, rc
    assert counts == dict(_NONE, tvl1_outer_loop=TV_LEVELS * TV_WARPS,
                          connected_components=RVIO_LABELLINGS), counts
    if not has_h5py:
        (layout,) = layouts.values()
        check_schema(saved_of_layout(layout), n, *clip.shape[1:],
                     "RVIO_2class")
    out["d: cli.train 2 ranks"] = dict(train_s=train_s, serve_agree=agree,
                                       process_launches=counts,
                                       seconds=time.perf_counter() - t0)

    # (e) more data entries than cards
    try:
        cli_train.main(argv)
        raise AssertionError("cli.train --data_axis 2 ran on one card")
    except ShardingError as e:
        log(f"train mesh e: cli.train --data_axis 2 on one card: "
            f"ShardingError({e})")
        out["e: data 2 on one card"] = str(e)
    return out


def train_mesh_check() -> int:
    """phase_train_mesh alone, after the kernels' build: a shorter call
    than the whole smoke, for work on this phase."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    _, has_h5py = phase_setup()
    clip, _ = echo_clip(CLIP_FRAMES, CLIP_H, CLIP_W)
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as workdir:
        t0 = time.perf_counter()
        out = phase_train_mesh(clip, workdir, has_h5py)
        log(f"train mesh ({time.perf_counter() - t0:.1f} s): "
            + json.dumps(out))
    return 0


def span_breakdown(sizes=((480, 640), (600, 800)), clips=4) -> int:
    """Where an Otsu TV-L1 clip's time goes, read from the program's spans
    (utils/tracing): per size, a warm-up clip, then ``clips`` echo clips
    of CLIP_FRAMES frames, each written as a DICOM and run through
    process_video in turn. Logs one JSON line per size: each span name's
    total and self seconds and calls per clip, the solver's warp and loop
    seconds per pyramid level, the counters per clip, and the share of
    each clip (host clock, synchronised before and after) that its
    top-level spans cover.

        python3 -c "import chip_smoke, sys;
            sys.exit(chip_smoke.span_breakdown())"
    """
    import torch

    from tee_optical_flow_torch.config import default_optical_flow_config
    from tee_optical_flow_torch.flow import pipeline
    from tee_optical_flow_torch.io.dicom_write import write_dicom_clip
    from tee_optical_flow_torch.utils import tracing

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    phase_setup()
    cfg = default_optical_flow_config()
    for h, w in sizes:
        with tempfile.TemporaryDirectory() as workdir:
            paths = []
            for k in range(clips + 1):
                paths.append(os.path.join(workdir, f"clip{k}.dcm"))
                frames = echo_clip(CLIP_FRAMES, h, w, seed=k)[0]
                write_dicom_clip(paths[-1],
                                 np.repeat(frames[..., None], 3, axis=-1),
                                 frame_rate=FPS, pixel_spacing=SPACING_CM)
            walls = []
            for k, path in enumerate(paths):
                if k == 1:
                    tracing.get_stage_report(reset=True)
                    before = tracing.get_counters()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pipeline.process_video(
                    path, "clip.hdf5", None, verbose=False, mode="otsu",
                    no_saliency=True, OF_algo="TVL1", config=cfg,
                    device="cuda", _save_fn=lambda *a, **kw: None)
                torch.cuda.synchronize()
                walls.append((t0, time.perf_counter()))
            report = tracing.get_stage_report(reset=True)
            after = tracing.get_counters()
        log_spans = tracing.get_spans()
        last = max(s["clip"] for s in log_spans if s["clip"] is not None)
        ids = list(range(last - clips + 1, last + 1))
        cover = [round(tracing._covered(
            [(s["start"], s["end"]) for s in log_spans
             if s["clip"] == cid and s["parent"] is None], t0, t1)
            / (t1 - t0), 4) for cid, (t0, t1) in zip(ids, walls[1:])]
        levels = {}
        for s in log_spans:
            if s["clip"] in ids and s["name"] in ("tvl1_warp", "tvl1_loop"):
                per = levels.setdefault(s["attrs"]["level"], {})
                per[s["name"]] = per.get(s["name"], 0.0) + (
                    s["end"] - s["start"]) / clips
        out = {"size": [h, w], "clips": clips,
               "clip_s": sum(t1 - t0 for t0, t1 in walls[1:]) / clips,
               "top_level_cover": cover,
               "stages": {name: {"total_s": v["total_s"] / clips,
                                 "self_s": v["self_s"] / clips,
                                 "calls": v["calls"] / clips}
                          for name, v in report.items()},
               "levels": dict(sorted(levels.items())),
               "counters": {k: (v - before.get(k, 0)) / clips
                            for k, v in after.items()
                            if v != before.get(k, 0)}}
        log(f"spans {h}x{w}: " + json.dumps(out))
    return 0


def _flops_per_frame(model, frames):
    """FLOPs of ``model``'s forward on one normalised frame
    (FlopCounterMode, from the shapes of its matrix products and
    convolutions; grad on, as the counter's module hooks need)."""
    from torch.utils.flop_counter import FlopCounterMode

    from tee_optical_flow_torch.models import preprocess_frames

    with FlopCounterMode(display=False) as counter:
        model(preprocess_frames(frames[:1], model.image_size))
    return counter.get_total_flops()


def _served_timing(tag, seg, clip4, hw, flops, peak_key="max_memory_gb"):
    """ms per frame of ``seg`` on a micro-batch (CUDA events), its share of
    the bfloat16 dense peak, the peak memory of the timed run and the
    weight bytes it keeps on the card."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: seg.labels_device(clip4, hw), 3) / clip4.shape[0]
    out = dict(ms_per_frame=ms, tflop_per_s=flops / (ms * 1e-3) / 1e12,
               share_of_bf16_peak=flops / (ms * 1e-3) / BF16_DENSE_OPS_PER_S,
               resident_weight_bytes=seg.resident_weight_bytes,
               **{peak_key: torch.cuda.max_memory_allocated() / 1e9})
    log(f"{tag}: {ms:.3f} ms per frame at micro-batch {clip4.shape[0]}, "
        f"{flops / 1e12:.4f} TFLOP per frame -> {out['tflop_per_s']:.2f} "
        f"TFLOP/s = {100 * out['share_of_bf16_peak']:.2f}% of the "
        f"{BF16_DENSE_OPS_PER_S / 1e12:.0f} TFLOP/s bfloat16 peak; max "
        f"memory allocated {out[peak_key]:.2f} GB; resident weights "
        f"{seg.resident_weight_bytes / 1e6:.1f} MB")
    return out


def vitdet_cli_run(clip, workdir, has_h5py, model_dtype, ckpt, dcm_dir,
                   wf_dir, tag, windows=SAM_WINDOWS):
    """cli.process.main over ``dcm_dir`` (one DICOM) with checkpoint dir
    ``ckpt`` under a PipelineConfig of BASELINE config 5 (RVIO_2class,
    TV-L1, saliency, WASE, waveforms) at ``model_dtype``: rc, 25 K1 calls,
    the schema and the masks against clean_mask on the CPU over the card's
    labels at the frames ``windows``. Returns (the served segmentor, what
    it printed)."""
    import torch

    from tee_optical_flow_torch.cli import process as cli
    from tee_optical_flow_torch.config import DeviceConfig, PipelineConfig
    from tee_optical_flow_torch.flow import pipeline as pl
    from tee_optical_flow_torch.utils.tracing import get_stage_report
    from tee_optical_flow_torch.io.hdf5 import optical_flow_layout

    n, h, w = clip.shape
    cfg = PipelineConfig(mode="RVIO_2class", of_algo="tvl1",
                         no_saliency=False, wase=True,
                         include_waveforms=True,
                         device=DeviceConfig(model_dtype=model_dtype))
    cfg_path = os.path.join(workdir, f"pipeline_{model_dtype}.json")
    cfg.to_json(cfg_path)
    out = os.path.join(workdir, f"out_{model_dtype}")
    argv = ["--dcm_folder", dcm_dir, "--save_folder", out,
            "--checkpoint_dir", ckpt, "--waveform_folder", wf_dir,
            "--config", cfg_path]
    saved, labels, segs, clip_s = {}, [], [], []

    def capture(save_path, flow_arr, echo_gray, mask_dict, metadata,
                waveforms, verbose=False, **kw):
        saved[save_path] = optical_flow_layout(
            flow_arr, echo_gray, mask_dict, metadata, waveforms, **kw)

    inner_video, inner_load = pl.process_video, cli.load_segmentor

    def timed_video(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner_video(*args, **kw)
        torch.cuda.synchronize()
        clip_s.append(time.perf_counter() - t0)

    def timed_load(*args, **kw):
        t0 = time.perf_counter()
        segs.append(record_labels(inner_load(*args, **kw), labels))
        torch.cuda.synchronize()
        segs.append(time.perf_counter() - t0)
        return segs[0]

    reset_counts()
    encoders = get_stage_report().get("sam_encoder", {}).get("calls", 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with substituted(pl, "process_video", timed_video), \
            substituted(cli, "load_segmentor", timed_load):
        rc = cli.main(argv, _save_fn=None if has_h5py else capture)
    torch.cuda.synchronize()
    counts = read_counts()
    encoders = get_stage_report()["sam_encoder"]["calls"] - encoders
    peak = torch.cuda.max_memory_allocated() / 1e9
    seg, load_s = segs
    log(f"{tag}: cli.process {' '.join(argv)}: rc {rc}, clip "
        f"{clip_s[0]:.3f} s (load_segmentor {load_s:.3f} s), max memory "
        f"allocated {peak:.2f} GB; launches {counts}")
    assert rc == 0, rc
    # vit_b in bfloat16 (int8 weights too) under no_grad: the attention
    # kernel once a block, VITB_BLOCKS a micro-batch through the encoder
    assert encoders > 0 and counts == dict(
        _NONE, tvl1_outer_loop=TV_LEVELS * TV_WARPS,
        connected_components=RVIO_LABELLINGS,
        rel_pos_attention=VITB_BLOCKS * encoders), (counts, encoders)
    if has_h5py:
        (path,) = [os.path.join(r, f) for r, _, fs in os.walk(out)
                   for f in fs if f.endswith(".hdf5")]
        saved = {path: layout_of_file(path)}
    (layout,) = saved.values()
    view = saved_of_layout(layout)
    check_schema(view, n, h, w, "RVIO_2class")
    masks_match_cpu(labels[0].cpu(), view["masks"], tag, windows)
    return seg, dict(clip_s=clip_s[0], load_segmentor_s=load_s,
                     max_memory_gb=peak,
                     launches=counts["tvl1_outer_loop"],
                     attention_launches=counts["rel_pos_attention"],
                     labels=labels[0])


def phase_vitdet(clip, workdir, has_h5py):
    """The ViT-Det SAM on the card (see VITDET_*): vit_b card against CPU;
    vit_b served through cli.process in bfloat16 and int8 (25 K1 calls a
    clip, masks against the CPU, int8 logits against bfloat16); vit_l and
    vit_h at full width and depth on one micro-batch in bfloat16 and int8;
    vit_b fine-tuning (vanilla, adapter blocks, decoder-only LoRA, then
    cli.train --arch vit_b -> load_segmentor -> cli.process); and the
    predictor, the mask generator and torch.export on one frame."""
    import copy
    import gc

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from tee_optical_flow_torch.cli import process as cli_process
    from tee_optical_flow_torch.cli import train as cli_train
    from tee_optical_flow_torch.io.dicom_write import write_dicom_clip
    from tee_optical_flow_torch.models import (
        make_clip_segmentor, preprocess_frames, sam_model_registry,
    )
    from tee_optical_flow_torch.models.amg import SamAutomaticMaskGenerator
    from tee_optical_flow_torch.models.export import (
        load_exported, save_exported,
    )
    from tee_optical_flow_torch.models.lora import init_lora
    from tee_optical_flow_torch.models.predictor import SamPredictor
    from tee_optical_flow_torch.train import checkpoint as ckpt_mod
    from tee_optical_flow_torch.train import loop
    from tee_optical_flow_torch.train.data import (
        PublicDataset, batch_iterator,
    )
    from tee_optical_flow_torch.utils.tracing import get_counters

    assert not (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)
    n, h, w = clip.shape
    hw = (h, w)
    out = {}
    kw = dict(num_classes=SAM_CLASSES, seed=VITDET_SEED)
    frames = torch.from_numpy(np.ascontiguousarray(clip[:SAM_MICRO_BATCH]))
    clip4 = frames.cuda()

    # 1. vit_b, card against CPU, one frame in strict float32
    log("--- ViT-Det: vit_b (768 wide, 12 blocks, 12 heads, window 14, "
        "global attention at blocks 2, 5, 8, 11) at 1024")
    t0 = time.perf_counter()
    cpu = sam_model_registry["vit_b"](device="cpu", **kw)
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in cpu.parameters())
    with torch.no_grad():
        t0 = time.perf_counter()
        ref = cpu(preprocess_frames(frames[:1], cpu.image_size))[0]
        cpu_s = time.perf_counter() - t0
        f32 = copy.deepcopy(cpu).cuda()
        got = f32(preprocess_frames(clip4[:1], f32.image_size))[0].cpu()
    del cpu
    side = f32.image_size // 4
    assert got.shape == (1, SAM_CLASSES, side, side) and bool(
        torch.isfinite(got).all())
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    bf16 = sam_model_registry["vit_b"](dtype=torch.bfloat16, **kw)
    with torch.no_grad():
        x4 = preprocess_frames(clip4, bf16.image_size)
        f32_4 = f32(x4)[0]
        low = bf16(x4)[0]
    agree16 = float((low.argmax(1) == f32_4.argmax(1)).float().mean())
    log(f"vit_b: {n_params} parameters, built on the CPU from a seeded "
        f"generator in {build_s:.1f} s; float32, TF32 off, 1 frame: card "
        f"vs CPU logits max-abs {err:.3g} = {rel:.3g} of their max-abs "
        f"{float(ref.abs().max()):.3f} (bound {VITDET_F32_REL}), CPU "
        f"forward {cpu_s:.1f} s; bfloat16 vs float32 labels on "
        f"{SAM_MICRO_BATCH} frames agree {agree16:.5f} (bound "
        f"{SAM_BF16_AGREE})")
    assert rel < VITDET_F32_REL, rel
    assert agree16 >= SAM_BF16_AGREE, agree16
    out["vit_b_card_vs_cpu"] = dict(f32_rel=rel, f32_max_abs=err,
                                    bf16_agree=agree16, params=n_params)
    del f32, f32_4

    # 2. vit_b served through cli.process in bfloat16 and in int8
    root = os.path.join(workdir, "vitdet")
    dcm_dir, wf_dir, ckpt = (os.path.join(root, d)
                             for d in ("dcm", "wf", "run"))
    for d in (dcm_dir, wf_dir, ckpt):
        os.makedirs(d)
    write_dicom_clip(os.path.join(dcm_dir, "vitb.dcm"),
                     np.repeat(clip[..., None], 3, axis=-1), frame_rate=FPS,
                     pixel_spacing=SPACING_CM)
    cohort_inputs(h, w, wf_dir, "vitb")
    with open(os.path.join(ckpt, "args.json"), "w") as f:
        json.dump({"num_cls": SAM_CLASSES, "arch": "vit_b"}, f)
    torch.save({k: v.cpu() for k, v in bf16.state_dict().items()},
               os.path.join(ckpt, "checkpoint_best.pth"))
    flops = _flops_per_frame(bf16, clip4)
    del bf16
    served, logits = {}, {}
    for dtype in ("bfloat16", "int8"):
        gc.collect()
        torch.cuda.empty_cache()
        seg, run = vitdet_cli_run(
            clip, root, has_h5py, dtype, ckpt, dcm_dir, wf_dir,
            f"vit_b {dtype}", SAM_WINDOWS if dtype == "bfloat16"
            else VITDET_WINDOWS)
        run.update(_served_timing(f"vit_b segmentor {dtype}", seg, clip4,
                                  hw, flops, "segmentor_max_memory_gb"))
        if dtype == "bfloat16":
            log(f"vit_b segmentor, one micro-batch of {SAM_MICRO_BATCH} "
                f"frames under torch.profiler:")
            profile_clip(lambda: seg.labels_device(clip4, hw))
        with torch.no_grad():
            logits[dtype] = seg.forward(x4)[0].float()
        served[dtype] = run
        del seg
    lab16, lab8 = served["bfloat16"].pop("labels"), served["int8"].pop(
        "labels")
    err8 = float((logits["int8"] - logits["bfloat16"]).abs().max())
    rel8 = err8 / float(logits["bfloat16"].abs().max())
    agree8 = float((lab8 == lab16).float().mean())
    log(f"vit_b int8 vs bfloat16 on {SAM_MICRO_BATCH} frames: logits "
        f"max-abs {err8:.4f} = {rel8:.4f} of their max-abs (bound "
        f"{VITDET_INT8_REL}); the clip's labels agree {agree8:.5f}")
    assert rel8 <= VITDET_INT8_REL, rel8
    out["vit_b_served"] = dict(served, gflop_per_frame=flops / 1e9,
                               int8_rel=rel8, int8_labels_agree=agree8)
    launches = [served[d]["launches"] for d in served]

    # 3. vit_l and vit_h at full width and depth on one micro-batch
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    for arch in ("vit_l", "vit_h"):
        t0 = time.perf_counter()
        model = sam_model_registry[arch](dtype=torch.bfloat16, **kw)
        build_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        arch_flops = _flops_per_frame(model, clip4)
        seg = make_clip_segmentor(model, micro_batch=SAM_MICRO_BATCH)
        res = {"bfloat16": _served_timing(f"{arch} bfloat16", seg, clip4,
                                          hw, arch_flops)}
        q8 = make_clip_segmentor(model, micro_batch=SAM_MICRO_BATCH,
                                 weights_int8=True)
        del seg, model
        gc.collect()
        torch.cuda.empty_cache()
        at_rest = (torch.cuda.memory_allocated() - base) / 1e9
        res["int8"] = _served_timing(f"{arch} int8", q8, clip4, hw,
                                     arch_flops)
        res["int8"]["allocated_at_rest_gb"] = at_rest
        out[arch] = dict(res, params=n_params, build_s=build_s,
                         gflop_per_frame=arch_flops / 1e9)
        log(f"{arch}: {n_params} parameters (built in {build_s:.1f} s); "
            f"the int8 segmentor alone holds {at_rest:.3f} GB allocated "
            f"on the card at rest")
        del q8
        gc.collect()
        torch.cuda.empty_cache()

    # 4. vit_b fine-tuning at 1024, float32
    gc.collect()
    torch.cuda.empty_cache()
    troot = os.path.join(root, "train")
    lst = train_inputs(clip, troot, range(n), "all")
    ds = PublicDataset(os.path.join(troot, "img"),
                       os.path.join(troot, "mask"), lst, phase="train",
                       image_size=TRAIN_SIZE, out_size=TRAIN_OUT,
                       seed=TRAIN_SEED)
    batches = list(batch_iterator(ds, TRAIN_BATCH, seed=TRAIN_SEED))
    images, labels = batches[0]
    train = {}
    for policy, build, extra in (
            ("vanilla", {}, {}),
            ("adapter", dict(adapter_blocks=VITDET_ADAPTER_BLOCKS,
                             use_decoder_adapter=True), {}),
            ("lora_decoder", {}, {})):
        gc.collect()
        torch.cuda.empty_cache()
        model = sam_model_registry["vit_b"](
            num_classes=SAM_CLASSES, image_size=TRAIN_SIZE, seed=TRAIN_SEED,
            **build)
        ftype = "lora" if policy == "lora_decoder" else policy
        init, step = loop.make_train_step(
            model, _train_runtime(TRAIN_WARM + VITDET_TRAIN_STEPS),
            finetune_type=ftype)
        state = init(init_lora(model, rank=4, seed=TRAIN_SEED, encoder=False)
                     if ftype == "lora" else None)
        n_p = sum(t.numel() for _, t in state.trainable)
        with FlopCounterMode(display=False, custom_mapping={
                torch.ops.aten.convolution_backward: conv_backward_flop}
                ) as counter:
            step.loss_and_grads(state, images, labels)
        step_flops = counter.get_total_flops()
        del counter
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = _median_step_ms(step, state, batches, TRAIN_WARM,
                             VITDET_TRAIN_STEPS)
        loss = float(step(state, images, labels)["total_loss"])
        rate = step_flops / (ms * 1e-3)
        train[policy] = dict(
            ms_per_step=ms, images_per_s=TRAIN_BATCH / (ms * 1e-3),
            gflop_per_step=step_flops / 1e9, tflop_per_s=rate / 1e12,
            share_of_f32_peak=rate / FP32_OPS_PER_S, trainable=n_p,
            max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            loss=loss)
        log(f"vit_b train {policy}, batch {TRAIN_BATCH} at {TRAIN_SIZE} "
            f"(float32): {n_p} trainable parameters, median {ms:.3f} ms "
            f"per step over {VITDET_TRAIN_STEPS} after {TRAIN_WARM}, "
            f"{train[policy]['images_per_s']:.2f} images/s, "
            f"{step_flops / 1e12:.3f} TFLOP per step -> {rate / 1e12:.2f} "
            f"TFLOP/s = {100 * rate / FP32_OPS_PER_S:.2f}% of the float32 "
            f"peak; max memory allocated "
            f"{train[policy]['max_memory_gb']:.2f} GB; loss {loss:.4f}")
        assert np.isfinite(loss), loss
        del model, state, step, init

    # cli.train --arch vit_b -> load_segmentor -> cli.process
    gc.collect()
    torch.cuda.empty_cache()
    n_tr, n_val = TRAIN_CLI_FRAMES
    tr_list = train_inputs(clip, troot, range(n_tr), "train")
    val_list = train_inputs(clip, troot, range(n_tr, n_tr + n_val), "val")
    run = os.path.join(troot, "run")
    argv = ["--arch", "vit_b", "--dir_checkpoint", run, "--img_folder",
            os.path.join(troot, "img"), "--mask_folder",
            os.path.join(troot, "mask"), "--train_img_list", tr_list,
            "--val_img_list", val_list, "--num_cls", str(SAM_CLASSES),
            "--epochs", str(TRAIN_CLI_EPOCHS), "-b", str(TRAIN_BATCH),
            "--lr", str(TRAIN_LR), "--warmup_period", "2", "--seed",
            str(TRAIN_SEED), "--image_size", str(TRAIN_SIZE), "--out_size",
            str(TRAIN_OUT), "--device", "cuda"]
    saved = []
    inner_save = ckpt_mod.save_checkpoint

    def keep_copy(dir_checkpoint, model, *args, **kwargs):
        saved[:] = [copy.deepcopy(model)]
        return inner_save(dir_checkpoint, model, *args, **kwargs)

    t0 = time.perf_counter()
    with substituted(ckpt_mod, "save_checkpoint", keep_copy):
        rc = cli_train.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    assert rc == 0 and saved, (rc, len(saved))
    with open(os.path.join(run, "args.json")) as f:
        assert json.load(f)["arch"] == "vit_b"
    served_f32 = cli_process.load_segmentor(run, model_dtype="float32")
    clip_dev = torch.from_numpy(np.ascontiguousarray(clip)).cuda()
    agree = float((served_f32.labels_device(clip_dev, hw)
                   == make_clip_segmentor(saved[0]).labels_device(
                       clip_dev, hw)).float().mean())
    del served_f32, saved[:]
    log(f"cli.train {' '.join(argv)}: rc {rc} in {train_s:.1f} s; "
        f"load_segmentor({run}) against the trained model: {agree:.6f} of "
        f"the clip's labels equal")
    assert agree == 1.0, agree
    gc.collect()
    torch.cuda.empty_cache()
    seg, trained_run = vitdet_cli_run(clip, troot, has_h5py, "bfloat16",
                                      run, dcm_dir, wf_dir, "vit_b trained",
                                      VITDET_WINDOWS)
    trained_run.pop("labels")
    launches.append(trained_run["launches"])
    del seg
    out["vit_b_train"] = dict(train, cli_train_s=train_s, serve_agree=agree,
                              served=trained_run)

    # 5. the predictor, the mask generator and export, one frame
    gc.collect()
    torch.cuda.empty_cache()
    model = sam_model_registry["vit_b"](dtype=torch.bfloat16, **kw)
    frame = np.repeat(clip[0][..., None], 3, axis=-1)
    pred = SamPredictor(model)
    set_ms = cuda_ms(lambda: pred.set_image(frame), 3)
    point = dict(point_coords=np.array([[w * 0.5, h * 0.6]]),
                 point_labels=np.array([1]))
    masks, ious, _ = pred.predict(**point)
    predict_ms = cuda_ms(lambda: pred.predict(**point), 5)
    assert masks.shape == (SAM_CLASSES, h, w) and np.isfinite(ious).all()
    t0 = time.perf_counter()
    records = SamAutomaticMaskGenerator(
        pred, points_per_side=VITDET_AMG_POINTS, pred_iou_thresh=-1e9,
        stability_score_thresh=-1.0).generate(frame)
    amg_s = time.perf_counter() - t0
    assert records and all(r["segmentation"].shape == (h, w)
                           for r in records)
    t0 = time.perf_counter()
    path = save_exported(model, os.path.join(root, "vit_b.pt2"), batch=1)
    export_s = time.perf_counter() - t0
    exported = load_exported(path)
    with torch.no_grad():
        x1 = x4[:1]
        lab_e, iou_e = exported(x1)
        logits_1, iou_1 = model(x1)
    eager = logits_1.argmax(1).to(torch.uint8)
    export_agree = float((lab_e == eager).float().mean())
    # the exported program records the attention kernel and runs it
    before = get_counters().get("launches.rel_pos_attention", 0)
    with torch.no_grad():
        exported(x1)
    export_attention = get_counters()["launches.rel_pos_attention"] - before
    assert export_attention == VITB_BLOCKS, export_attention
    log(f"vit_b predictor on one {h}x{w} frame (bfloat16): set_image "
        f"{set_ms:.3f} ms, predict {predict_ms:.3f} ms (CUDA events, host "
        f"work included); SamAutomaticMaskGenerator({VITDET_AMG_POINTS}x"
        f"{VITDET_AMG_POINTS} points, filters open) {len(records)} records "
        f"in {amg_s:.2f} s; torch.export of the forward at batch 1 in "
        f"{export_s:.1f} s ({os.path.getsize(path) / 1e6:.1f} MB): loaded "
        f"program's labels equal eager on {export_agree:.6f}, iou max-abs "
        f"{float((iou_e - iou_1).abs().max()):.3g}")
    assert export_agree == 1.0, export_agree
    out["predictor"] = dict(export_attention_launches=export_attention,
                            set_image_ms=set_ms, predict_ms=predict_ms,
                            amg_records=len(records), amg_s=amg_s,
                            export_s=export_s, export_agree=export_agree)
    del model, pred, exported
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def _same_layout(a, b, where=""):
    """Whether two optical_flow_layout dicts are equal, arrays bit for
    bit; raises AssertionError naming the first difference."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (where, sorted(a), sorted(b))
        for k in a:
            _same_layout(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_layout(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, (where, a, b)


def _ramp_pair():
    """tests/test_tvl1.py's gamma case (seed 0): a 64x80 texture shifted
    by (1.5, -1.0) px with a 0-30 brightness ramp on the second frame."""
    from scipy import ndimage

    rng = np.random.default_rng(0)
    img = ndimage.gaussian_filter(rng.uniform(size=(64, 80)), 2.5)
    img = ((img - img.min()) / (img.max() - img.min()) * 200 + 20
           ).astype(np.float32)
    shifted = ndimage.shift(img, (-1.0, 1.5), order=3, mode="nearest")
    ramp = np.linspace(0, 30, 80, dtype=np.float32)[None, :]
    return img, np.clip(shifted + ramp, 0, 255).astype(np.float32)


def _statistics_only(self, filt_arr, frame_times, sys_frames, dia_frames,
                     nframes, *args, cc_method="angle", **kw):
    """VisualizationManager.plot_peak_line without the drawing: the
    9-tuple it returns with return_statistics (the card's machine has no
    matplotlib)."""
    return self.single_statistics(self.single_peak_data(
        filt_arr, frame_times, sys_frames, dia_frames, nframes,
        cc_method=cc_method))


def _radlong_statistics_only(self, hi_rad, lo_rad, hi_long, lo_long,
                             frame_times, sys_frames, dia_frames, nframes,
                             *args, cc_method="angle", **kw):
    """plot_peak_line_radlong without the drawing: its 18-tuple."""
    rad = self.radlong_peak_data(hi_rad, lo_rad, frame_times, sys_frames,
                                 dia_frames, nframes, cc_method=cc_method)
    lng = self.radlong_peak_data(hi_long, lo_long, frame_times, sys_frames,
                                 dia_frames, nframes, cc_method=cc_method)
    return self.radlong_statistics(rad, lng)


def phase_compressed_gamma(clip, truth, workdir, layout):
    """Compressed DICOM clips, TV-L1 gamma, the legacy shim and
    PromptAutoEncoder on the card.

      * the native reader: builds csrc/dicomlite.cpp with g++ (seconds
        printed) and asserts it loads;
      * the 33x480x640 clip written uncompressed, RLE and JPEG-Lossless by
        the port's writer, each read through read_dicom_clip with the
        native reads counted (a silent fall-back to the Python parser
        fails), bit-equal to the clip; the least of DICOM_READS reads of
        each, and of the uncompressed file through the pure-Python parser;
      * process_video(mode="otsu", OF_algo="TVL1") on the JPEG-Lossless
        file and on the uncompressed one: 25 K1 calls and 25 device
        launches each besides the masks' two labellings, the saved layouts
        bit-equal;
      * process_video with tvl1_gamma=GAMMA under the production config on
        the uncompressed file: the wall end-point error within the TV-L1
        bounds, no K1, every device launch but the labellings' a
        standalone median (tvl1_median5x5, counted by its wrapper and by
        the library); the
        median bit-equal to its plain version on the finest level's
        arguments the path handed it, timed there; the gamma solve alone
        at epsilon 0 on GAMMA_EPS0_FRAMES frames with GAMMA_MEDIANS_EPS0
        median launches;
      * the brightness-ramp case on the card at gamma 1 and 0;
      * legacy.percentile_plot and percentile_plot_radlong on the config-4
        dataset (``layout``) through both gates with the drawing left out,
        against the same calls on the CPU from the card's AV centroid
        track (COHORT_ROW_RTOL relative, integers equal);
      * PromptAutoEncoder (seeded random weights) on PAE_FRAMES
        preprocessed frames at PAE_SIZE, card against CPU in float32.

    Returns the stage seconds and readings, and the median's record for
    the kernels line."""
    import torch

    from tee_optical_flow_torch import legacy
    from tee_optical_flow_torch.analysis import centroid as cen
    from tee_optical_flow_torch.analysis import histograms as hist
    from tee_optical_flow_torch.config import default_optical_flow_config
    from tee_optical_flow_torch.dataset import OpticalFlowDataset
    from tee_optical_flow_torch.flow.pipeline import (
        compute_clip_flow, process_video,
    )
    from tee_optical_flow_torch.io import dicom_native
    from tee_optical_flow_torch.io.dicom import read_dicom_clip
    from tee_optical_flow_torch.io.dicom_write import write_dicom_clip
    from tee_optical_flow_torch.io.hdf5 import optical_flow_layout
    from tee_optical_flow_torch.models.prompt_encoder import (
        PromptAutoEncoder,
    )
    from tee_optical_flow_torch.models.sam import preprocess_frames
    from tee_optical_flow_torch.ops import tvl1 as tt
    from tee_optical_flow_torch.ops import warp as tw
    from tee_optical_flow_torch.ops.cuda_lib import device_launch_count
    from tee_optical_flow_torch.ops.imaging import gray_from_clip, img2uint8
    from tee_optical_flow_torch.utils import get_stage_report
    from tee_optical_flow_torch.viz.manager import VisualizationManager

    n, h, w = clip.shape
    out = {}
    log(f"--- compressed DICOM and TV-L1 gamma on {n}x{h}x{w}")
    assert dicom_native.native_available(), "dicomlite did not build"
    out["dicomlite_build_s"] = dicom_native.build_info["seconds"]
    log(f"dicomlite: g++ build {out['dicomlite_build_s']:.2f} s in this "
        f"process (0 where an earlier process built it), "
        f"{dicom_native.build_info['path']}")

    # the clip in three transfer syntaxes, read back natively
    rgb = np.repeat(clip[..., None], 3, axis=-1)
    paths, sizes = {}, {}
    for syntax in ("native", "rle", "jpeg_lossless"):
        paths[syntax] = os.path.join(workdir, f"echo_{syntax}.dcm")
        t0 = time.perf_counter()
        write_dicom_clip(paths[syntax], rgb, frame_rate=FPS,
                         pixel_spacing=SPACING_CM, transfer_syntax=syntax)
        sizes[syntax] = os.path.getsize(paths[syntax])
        log(f"write_dicom_clip {syntax}: {time.perf_counter() - t0:.2f} s, "
            f"{sizes[syntax] / 1e6:.2f} MB")
    native_reads = []
    inner_read = dicom_native.native_read

    def counting(path):
        got = inner_read(path)
        if got is not None:
            native_reads.append(path)
        return got

    read_s = {}
    with substituted(dicom_native, "native_read", counting):
        for syntax, path in paths.items():
            times = []
            for _ in range(DICOM_READS):
                t0 = time.perf_counter()
                _, arr = read_dicom_clip(path)
                times.append(time.perf_counter() - t0)
                assert np.array_equal(arr, rgb), syntax
            read_s[f"native_{syntax}"] = min(times)
    assert len(native_reads) == 3 * DICOM_READS, native_reads
    with substituted(dicom_native, "native_read", lambda path: None):
        times = []
        for _ in range(DICOM_READS):
            t0 = time.perf_counter()
            _, arr = read_dicom_clip(paths["native"])
            times.append(time.perf_counter() - t0)
        assert np.array_equal(arr, rgb)
        read_s["python_native"] = min(times)
    log("read_dicom_clip seconds (least of "
        f"{DICOM_READS}, host clock): " + ", ".join(
            f"{k} {v:.4f}" for k, v in read_s.items())
        + f"; {len(native_reads)} native reads, every array bit-equal")
    out.update(read_s=read_s, file_mb={k: v / 1e6 for k, v in sizes.items()})

    # the production path on the JPEG-Lossless file and the uncompressed one
    cfg = default_optical_flow_config()
    layouts, saved = {}, {}

    def capture(save_path, flow_arr, echo_gray, mask_dict, metadata,
                waveforms, verbose=False, **kw):
        saved["layout"] = optical_flow_layout(flow_arr, echo_gray, mask_dict,
                                              metadata, waveforms, **kw)
        saved.update(flow=flow_arr, echo=echo_gray, masks=mask_dict,
                     attrs={"nframes": metadata["nframes"],
                            "mode": kw["mode"],
                            "frame_rate": metadata["frame_rate"],
                            "pixel_spacing": metadata["pixel_spacing"]})

    kw = dict(verbose=False, mode="otsu", OF_algo="TVL1", no_saliency=True,
              _save_fn=capture)
    stage_s = {}
    for syntax in ("jpeg_lossless", "native"):
        get_stage_report(reset=True)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recording_labellings() as calls:
            process_video(paths[syntax], "unused.hdf5", None, config=cfg,
                          **kw)
        torch.cuda.synchronize()
        clip_s = time.perf_counter() - t0
        counts, dev = read_counts(), device_launch_count()
        stages = get_stage_report()
        stage_s[syntax] = {k: v["total_s"] for k, v in stages.items()}
        log(f"process_video otsu TVL1 on the {syntax} DICOM: {clip_s:.3f} s,"
            f" launches {counts}, {dev} device launches; dicom_read stage "
            f"{stage_s[syntax].get('dicom_read', float('nan')):.3f} s")
        assert counts == dict(_NONE, tvl1_outer_loop=TV_LEVELS * TV_WARPS,
                              connected_components=OTSU_LABELLINGS), counts
        assert dev == TV_LEVELS * TV_WARPS + planned_label_launches(calls), \
            dev
        layouts[syntax] = saved.pop("layout")
        out[f"otsu_{syntax}_clip_s"] = clip_s
    _same_layout(layouts["jpeg_lossless"], layouts["native"])
    log("the JPEG-Lossless clip's saved layout is bit-equal to the "
        "uncompressed clip's")
    out["dicom_read_stage_s"] = {k: v.get("dicom_read")
                                 for k, v in stage_s.items()}

    # TV-L1 gamma at full width under the production config
    gcfg = default_optical_flow_config()
    gcfg.tvl1_gamma = GAMMA
    medians = {}
    inner_median = tt.median_filter_5x5

    def recording(f):
        if tuple(f.shape) not in medians:
            medians[tuple(f.shape)] = f.clone()
        return inner_median(f)

    recording.__dict__ = inner_median.__dict__
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with substituted(tt, "median_filter_5x5", recording):
        process_video(paths["native"], "unused.hdf5", None, config=gcfg,
                      **kw)
    torch.cuda.synchronize()
    gamma_s = time.perf_counter() - t0
    # the Otsu masks' two labellings launch the rest
    counts = read_counts()
    dev = device_launch_count() - label_launches()
    log(f"process_video otsu TVL1 gamma={GAMMA} (epsilon "
        f"{gcfg.tvl1_epsilon}): {gamma_s:.3f} s, launches {counts}, {dev} "
        f"device launches (at most {GAMMA_MEDIANS_EPS0}: the epsilon stop "
        f"ends a warp's outer loop once every pair is frozen)")
    assert counts == dict(_NONE, median_filter_5x5=dev,
                          connected_components=OTSU_LABELLINGS), counts
    assert 0 < dev <= GAMMA_MEDIANS_EPS0, dev
    check_outputs(saved, n, h, w, truth, (WALL_MEDIAN_EPE_PX,
                                          WALL_P95_EPE_PX))
    out.update(gamma_clip_s=gamma_s, gamma_median_launches=dev)

    # the design's median count: the solve alone at epsilon 0, on the first
    # GAMMA_EPS0_FRAMES frames (the count does not depend on the pairs)
    images = img2uint8(gray_from_clip(torch.from_numpy(
        clip[:GAMMA_EPS0_FRAMES]).cuda()))
    ecfg = default_optical_flow_config()
    ecfg.tvl1_gamma, ecfg.tvl1_epsilon = GAMMA, 0.0
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compute_clip_flow(images, "TVL1", ecfg)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = read_counts()["median_filter_5x5"]
    log(f"gamma solve alone at epsilon 0, {images.shape[0] - 1} pairs at "
        f"{h}x{w}: {solve_s:.3f} s, {launches} median launches (design "
        f"{GAMMA_MEDIANS_EPS0})")
    assert launches == GAMMA_MEDIANS_EPS0, launches
    out.update(gamma_eps0_solve_s=solve_s, gamma_eps0_pairs=len(images) - 1,
               gamma_eps0_medians=launches)

    # the standalone median on the finest level's arguments
    arg = medians[max(medians, key=lambda s: s[1] * s[2])]
    b, lh, lw = arg.shape
    npx = b * lh * lw
    got = tw.median_filter_5x5(arg)
    ref = tw.median_filter_5x5_plain(arg)
    err = float((got - ref).abs().max())
    assert torch.equal(got, ref), err
    ms = cuda_ms(lambda: tw.median_filter_5x5(arg), 20)
    plain_ms = cuda_ms(lambda: tw.median_filter_5x5_plain(arg), 5)
    bms, by = bound(2 * 4 * npx, OPS_MEDIAN_PLANE * npx)
    log(f"median 5x5 on the gamma path's ({b},{lh},{lw}) arguments: "
        f"max|kernel - plain| = {err} (tolerance 0: bit-equal); {ms:.4f} ms "
        f"kernel, {plain_ms:.4f} ms plain, bound {bms:.4f} ms ({by}); "
        f"shapes the path handed it: {sorted(medians)}")
    median = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                  bound_by=by, shape=[b, lh, lw])

    # the JAX package's brightness-ramp case
    i0, i1 = (torch.from_numpy(a[None]).cuda() for a in _ramp_pair())
    ramp = {}
    for gamma in (1.0, 0.0):
        flow = tt.tvl1_flow_pairs(i0, i1, gamma=gamma, nscales=3, zoom=0.8,
                                  warps=5, outer_iters=6, inner_iters=20,
                                  use_median=True)[0].cpu().numpy()
        flow = flow[10:-10, 10:-10]
        ramp[gamma] = float(np.median(np.hypot(flow[..., 0] - 1.5,
                                               flow[..., 1] + 1.0)))
    log(f"brightness ramp 64x80: median end-point error {ramp[1.0]:.4f} px "
        f"at gamma 1 (bound {GAMMA_RAMP_BOUND}), {ramp[0.0]:.4f} px at "
        f"gamma 0 (must exceed {GAMMA_RAMP_PLAIN_MIN})")
    assert ramp[1.0] < GAMMA_RAMP_BOUND and ramp[0.0] > GAMMA_RAMP_PLAIN_MIN
    out["ramp_epe_px"] = {"gamma1": ramp[1.0], "gamma0": ramp[0.0]}

    # the legacy shim on the config-4 dataset, card against CPU
    ds = OpticalFlowDataset("echo_config4.hdf5", _file_override=layout)
    nf = ds.nframes
    cents = cen.calc_AV_centroid(ds.get_mask("av"), nf, device="cuda")
    legacy_s = {}
    with substituted(VisualizationManager, "plot_peak_line",
                     _statistics_only), \
            substituted(VisualizationManager, "plot_peak_line_radlong",
                        _radlong_statistics_only):
        for fn in (legacy.percentile_plot, legacy.percentile_plot_radlong):
            for cc_method in ("ecg_lazy", "arterial"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = fn(ds, "velocity", "rv", cc_method, save_dir=workdir,
                         device="cuda")
                legacy_s[f"{fn.__name__}_{cc_method}"] = \
                    time.perf_counter() - t0
                with substituted(hist, "calc_AV_centroid",
                                 lambda *a, **k: cents):
                    ref = fn(ds, "velocity", "rv", cc_method,
                             save_dir=workdir, device="cpu")
                assert len(got) == len(ref) == (
                    18 if fn is legacy.percentile_plot_radlong else 9)
                for i, (g, r) in enumerate(zip(got, ref)):
                    if isinstance(r, (int, np.integer)) or r == 0:
                        assert g == r, (fn.__name__, cc_method, i, g, r)
                    else:
                        assert abs(g - r) <= COHORT_ROW_RTOL * abs(r), \
                            (fn.__name__, cc_method, i, g, r)
                assert any(v != 0 for v in got), (fn.__name__, cc_method)
    log("legacy percentile_plot / percentile_plot_radlong, both gates: "
        "equal to the CPU's (floats within " + f"{COHORT_ROW_RTOL} relative)"
        "; seconds on the card " + ", ".join(
            f"{k} {v:.3f}" for k, v in legacy_s.items()))
    out["legacy_s"] = legacy_s

    # PromptAutoEncoder at 1024, card against CPU in float32
    torch.manual_seed(SAM_SEED)
    pae = PromptAutoEncoder().eval()
    x = preprocess_frames(torch.from_numpy(rgb[:PAE_FRAMES]), PAE_SIZE)
    with torch.no_grad():
        _, dense_c = pae(x)
        pae_cuda = pae.cuda()
        xc = x.cuda()
        sparse_g, dense_g = pae_cuda(xc)
        pae_ms = cuda_ms(lambda: pae_cuda(xc), 10)
    rel = float((dense_g.cpu() - dense_c).abs().max()
                / dense_c.abs().max())
    log(f"PromptAutoEncoder {tuple(x.shape)} -> dense "
        f"{tuple(dense_g.shape)}, sparse {tuple(sparse_g.shape)}: "
        f"max|card - CPU| / max|CPU| = {rel:.3g} (bound {PAE_REL}); "
        f"{pae_ms:.3f} ms per call on the card")
    out_hw = (PAE_SIZE - 2) // 4
    assert tuple(dense_g.shape) == (PAE_FRAMES, 256, out_hw, out_hw)
    assert tuple(sparse_g.shape) == (PAE_FRAMES, 0, 256)
    assert rel <= PAE_REL, rel
    out.update(pae_rel_err=rel, pae_ms=pae_ms)
    return out, median


def host_syncs(fn):
    """Run fn() under torch.cuda.set_sync_debug_mode("warn"): the port's
    source lines (the innermost tee_optical_flow_torch frame) at which
    torch reported a synchronising CUDA operation, with their counts."""
    import traceback
    import warnings

    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    sites = {}

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()
                if "tee_optical_flow_torch" in f.filename]
        key = (f"{os.path.relpath(ours[-1].filename, root)}:"
               f"{ours[-1].lineno}" if ours else f"{filename}:{lineno}")
        sites[key] = sites.get(key, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sites


def phase_mesh(clip, truth, workdir):
    """Frame-axis data parallelism on the one card (MESH_*): the sharded
    clip flow (TV-L1 on 1 and 2 entries, DeepFlow on 2) bit-equal to the
    unsharded solve, its launches per shard from the wrappers' counts and
    the kernel library's, the wall EPE under the path's bounds, seconds
    per shard and per solve, and the host synchronisations of a 2-shard
    solve (each holds back the start of the next shard); the sharded vit_t
    segmentor against the unsharded one; load_segmentor(data_axis=2)
    refused on one card."""
    import torch

    from tee_optical_flow_torch.cli.process import load_segmentor
    from tee_optical_flow_torch.config import default_optical_flow_config
    from tee_optical_flow_torch.exceptions import ShardingError
    from tee_optical_flow_torch.flow import pipeline as tp
    from tee_optical_flow_torch.models import (
        build_sam_vit_t, make_clip_segmentor, preprocess_frames,
    )
    from tee_optical_flow_torch.ops.cuda_lib import device_launch_count
    from tee_optical_flow_torch.ops.deepflow import deepflow_config_kwargs
    from tee_optical_flow_torch.ops.imaging import gray_from_clip, img2uint8
    from tee_optical_flow_torch.ops.tvl1 import tvl1_config_kwargs
    from tee_optical_flow_torch.parallel import make_mesh

    cfg = default_optical_flow_config()
    n, h, w = clip.shape
    images = img2uint8(gray_from_clip(torch.from_numpy(clip).cuda()))
    out = {}
    for algo, name, kw, counter, shard_counts in (
            ("TVL1", "tvl1_flow_pairs", tvl1_config_kwargs(cfg),
             "tvl1_outer_loop", MESH_SHARDS),
            ("deepflow", "deepflow_pairs", deepflow_config_kwargs(cfg),
             "sor_sweeps", (2,))):
        path = PATHS[algo]
        solve = getattr(tp, name)
        for _ in range(2):  # the second solve is timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = solve(images[:-1], images[1:], **kw)
            torch.cuda.synchronize()
        rec = {"unsharded_s": time.perf_counter() - t0}
        for shards in shard_counts:
            mesh = make_mesh(devices=["cuda:0"] * shards)
            shard_s = []

            def timed(a, b, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                r = solve(a, b, **k)
                torch.cuda.synchronize()
                shard_s.append(time.perf_counter() - t)
                return r

            for run in range(2):
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if run == 0:
                    with substituted(tp, name, timed):
                        flow = tp.compute_clip_flow_sharded(images, mesh,
                                                            algo, cfg)
                else:
                    flow = tp.compute_clip_flow_sharded(images, mesh, algo,
                                                        cfg)
                torch.cuda.synchronize()
                solve_s = time.perf_counter() - t0
                counts, dev = read_counts(), device_launch_count()
                want = dict(_NONE, **{counter: shards * path["counts"][
                    counter]})
                assert counts == want, (algo, shards, counts)
                assert dev == shards * path["device_launches"], (algo, dev)
            assert flow.shape == ref.shape == (n - 1, h, w, 2)
            err = float((flow - ref).abs().max())
            log(f"mesh {algo}, {shards} shard(s) of cuda:0: "
                f"compute_clip_flow_sharded {solve_s:.3f} s (first, with a "
                f"synchronise around each shard: shards "
                + ", ".join(f"{t:.3f}" for t in shard_s)
                + f" s), unsharded {rec['unsharded_s']:.3f} s; launches "
                f"{counts[counter]} ({path['counts'][counter]} per shard), "
                f"{dev} device launches; max|sharded - unsharded| = {err}")
            assert torch.equal(flow, ref), (algo, shards, err)
            med, p95 = wall_epe(flow.cpu().numpy(), truth, path["bounds"])
            rec[f"shards_{shards}"] = dict(
                solve_s=solve_s, shard_s=shard_s, launches=counts[counter],
                device_launches=dev, max_abs_err=err, epe_median=med,
                epe_p95=p95)
        mesh2 = make_mesh(devices=["cuda:0"] * 2)
        rec["host_syncs"] = host_syncs(lambda: tp.compute_clip_flow_sharded(
            images, mesh2, algo, cfg))
        log(f"mesh {algo}: host synchronisations of a 2-shard solve "
            f"(source line: count): {json.dumps(rec['host_syncs'])}")
        out[algo] = rec
        del ref, flow

    # the segmentor: bfloat16 labels and float32 logits, unsharded and on
    # the 2-entry mesh (one replica: the entry repeats the model's card)
    gray = torch.from_numpy(clip).cuda()
    mesh2 = make_mesh(devices=["cuda:0"] * 2)
    seg = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = build_sam_vit_t(num_classes=SAM_CLASSES, seed=SAM_SEED,
                                dtype=dtype)
        pair = [make_clip_segmentor(model, micro_batch=SAM_MICRO_BATCH,
                                    mesh=m) for m in (None, mesh2)]
        assert pair[0].resident_weight_bytes == pair[1].resident_weight_bytes
        tag = str(dtype).split(".")[-1]
        if dtype == torch.bfloat16:
            labels, secs = [], []
            for sg in pair:
                sg.labels_device(gray[:SAM_MICRO_BATCH], (h, w))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                labels.append(sg.labels_device(gray, (h, w)))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            agree = float((labels[0] == labels[1]).float().mean())
            seg[tag] = dict(agree=agree, unsharded_s=secs[0],
                            sharded_s=secs[1])
            log(f"mesh segmentor {tag}: {n} frames {secs[0]:.3f} s "
                f"unsharded, {secs[1]:.3f} s on 2 entries; labels equal "
                f"{100 * agree:.2f}% (bound {100 * MESH_SEG_AGREE}%)")
            assert agree >= MESH_SEG_AGREE, agree
        else:
            with torch.no_grad():
                x = preprocess_frames(gray[:SAM_MICRO_BATCH],
                                      model.image_size)
                whole = pair[0].forward(x)[0]
                half = SAM_MICRO_BATCH // 2
                halves = torch.cat([pair[1].forward(x[:half])[0],
                                    pair[1].forward(x[half:])[0]])
            rel = float((whole - halves).abs().max() / whole.abs().max())
            seg[tag] = dict(logits_rel=rel)
            log(f"mesh segmentor {tag}: logits of a micro-batch in two "
                f"halves against whole: {rel:.3g} of max-abs (bound "
                f"{MESH_F32_REL})")
            assert rel <= MESH_F32_REL, rel
        del model, pair
    out["segmentor"] = seg

    empty = os.path.join(workdir, "no_checkpoint")
    os.makedirs(empty, exist_ok=True)
    if torch.cuda.device_count() == 1:
        try:
            load_segmentor(empty, data_axis=2)
        except ShardingError as exc:
            out["data_axis_2"] = str(exc)
        else:
            raise AssertionError("load_segmentor(data_axis=2) on one card")
        assert out["data_axis_2"] == "mesh 2x1 != 1 devices", out
        log(f"load_segmentor(data_axis=2) on one card: ShardingError "
            f"{out['data_axis_2']!r}")
    return out


def _baseline_cases():
    """(name, constructor, inputs, frames held on the CPU) of
    phase_baselines, seeded."""
    import torch

    from tee_optical_flow_torch.models import baselines as tb

    rng = np.random.default_rng(BASELINE_SEED)
    b, s = BASELINE_BATCH, BASELINE_SIZE

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    img = normal(b, 3, s, s)
    critic = [torch.from_numpy(rng.uniform(size=(b, 1, s, s)).astype(
        np.float32)), torch.from_numpy(rng.integers(0, 2, b).astype(
            np.float32)), img]
    cases = []
    for name in ("unet", "transunet", "munet", "goinnet", "vit", "resnet",
                 "seresnet", "vgg", "squeezenet", "efficientnet", "vae",
                 "discriminator", "tag", "implicitnet",
                 "implicitefficientnet"):
        kw = dict(image_size=s) if name in ("vit", "vae") else {}
        cases.append((name, lambda name=name, kw=kw: tb.get_network(
            name, **kw), critic if name.startswith("implicit") else [img],
            b))
    cases.append(("smalldecoder", tb.SmallDecoder,
                  [normal(b, 256, s // 8, s // 8)], b))
    u = BASELINE_UNET_SIZE
    cases.append((f"unet {u}", tb.UNet, [normal(b, 3, u, u)], 1))
    return cases


def phase_baselines():
    """The baseline zoo on the card (BASELINE_*): each network's forward
    against the same module's CPU forward, its CUDA-event ms per batch,
    parameters and peak memory; one UNet AdamW step at 1024 with its
    batch statistics committed; one WGAN-GP update of the
    Discriminator, its loss against the CPU's."""
    import copy

    import torch
    import torch.nn.functional as F

    from tee_optical_flow_torch.models import baselines as tb
    from tee_optical_flow_torch.models.common import commit_batch_stats
    from tee_optical_flow_torch.train import gan

    assert not (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)
    out = {}
    for name, build, inputs, held in _baseline_cases():
        torch.manual_seed(BASELINE_SEED)
        cpu = build().eval()
        card = copy.deepcopy(cpu).cuda()
        xs = [t.cuda() for t in inputs]

        @torch.no_grad()
        def forward(net=card, xs=xs):
            return net(*xs)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got = forward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        ms = cuda_ms(forward, 3)
        t0 = time.perf_counter()
        with torch.no_grad():
            ref = cpu(*[t[:held] for t in inputs])
        cpu_s = time.perf_counter() - t0
        rel = 0.0
        for g, r in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            g = g[:held].float().cpu()
            assert g.shape == r.shape and bool(torch.isfinite(g).all())
            rel = max(rel, float((g - r).abs().max() / r.abs().max()))
        params = sum(p.numel() for p in cpu.parameters())
        out[name] = dict(ms=ms, params=params, peak_gb=peak, rel=rel,
                         cpu_s=cpu_s)
        log(f"baseline {name}: {ms:.3f} ms per batch of "
            f"{tuple(inputs[0].shape)}, {params} parameters, peak "
            f"{peak:.2f} GB; card vs CPU ({held} frame(s), {cpu_s:.1f} s on "
            f"the CPU) {rel:.3g} of max-abs (bound {BASELINE_REL})")
        assert rel <= BASELINE_REL, (name, rel)
        del cpu, card, xs, got, ref

    # one AdamW step of UNet at 1024 in train mode
    u, b = BASELINE_UNET_SIZE, BASELINE_BATCH
    torch.manual_seed(BASELINE_SEED)
    net = tb.UNet().cuda()
    opt = torch.optim.AdamW(net.parameters(), lr=1e-4)
    rng = np.random.default_rng(BASELINE_SEED)
    x = torch.from_numpy(rng.normal(size=(b, 3, u, u)).astype(
        np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 2, (b, u, u))).cuda()
    running = net.down0.bn0.running_var.clone()
    moved = []

    def step():
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(net(x, train=True), y)
        loss.backward()
        opt.step()
        moved.append(commit_batch_stats(net))
        return loss.detach()

    torch.cuda.reset_peak_memory_stats()
    first = float(step())
    events = [_event_ms(step) for _ in range(BASELINE_TRAIN_STEPS)]
    torch.cuda.synchronize()
    step_ms = float(np.median([s.elapsed_time(e) for s, e in events]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in net.modules())
    assert np.isfinite(first) and moved == [n_bn] * len(moved), moved
    assert not torch.equal(running, net.down0.bn0.running_var)
    out["unet_train_step"] = dict(ms=step_ms, peak_gb=peak, loss=first,
                                  batch_norms=n_bn)
    log(f"baseline UNet AdamW step at {b}x3x{u}x{u}: {step_ms:.3f} ms "
        f"(median of {BASELINE_TRAIN_STEPS}), peak {peak:.2f} GB, first "
        f"loss {first:.4f}, {n_bn} batch norms committed per step")
    del net, opt, x, y

    # one WGAN-GP discriminator update (double backward through the
    # convolutions), its loss against the CPU's on the same weights
    s = BASELINE_SIZE
    torch.manual_seed(BASELINE_SEED)
    cpu = tb.Discriminator()
    card = copy.deepcopy(cpu).cuda()
    real, fake = (torch.from_numpy(rng.normal(size=(b, 3, s, s)).astype(
        np.float32)) for _ in range(2))
    eps = torch.from_numpy(rng.uniform(size=(b, 1, 1, 1)).astype(
        np.float32))
    ref = float(gan.discriminator_loss(cpu, real, fake, eps=eps)[0].detach())
    opt = torch.optim.AdamW(card.parameters(), lr=1e-4)
    before = card.head.weight.detach().clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, (d_real, d_fake, gp) = gan.update_d(
        card, opt, real.cuda(), fake.cuda(), eps=eps.cuda())
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    rel = abs(float(loss) - ref) / abs(ref)
    out["wgan_gp_update"] = dict(loss=float(loss), cpu_loss=ref, rel=rel,
                                 gp=float(gp), s=update_s)
    log(f"baseline WGAN-GP update of the Discriminator at {b}x3x{s}x{s}: "
        f"loss {float(loss):.6f} (CPU {ref:.6f}, {rel:.3g} relative, bound "
        f"{BASELINE_REL}), gradient penalty {float(gp):.6f}, {update_s:.3f} "
        f"s with the first call's set-up")
    assert rel <= BASELINE_REL and not torch.equal(before, card.head.weight)
    return out


def mesh_check() -> int:
    """phase_mesh alone on the 480x640 clip, after the kernels' build: a
    shorter call than the whole smoke, for work on this phase."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    phase_setup()
    clip, truth = echo_clip(CLIP_FRAMES, CLIP_H, CLIP_W)
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as workdir:
        t0 = time.perf_counter()
        out = phase_mesh(clip, truth, workdir)
        log(f"mesh ({time.perf_counter() - t0:.1f} s): " + json.dumps(out))
    return 0


def baselines_check() -> int:
    """phase_baselines alone: a shorter call than the whole smoke."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    phase_setup()
    t0 = time.perf_counter()
    out = phase_baselines()
    log(f"baselines ({time.perf_counter() - t0:.1f} s): " + json.dumps(out))
    return 0


def batch_dependence() -> int:
    """Why a batched resize is not a per-pair one on the card: the
    DeepFlow path's coarsest cubic upsample (30x40 -> 60x80, the
    production pyramid of the 480x640 clip) as one batched product over
    32 images and over their first 16, the rows compared, beside
    ops/warp._resize's grouped products; deepflow_pairs over the clip's
    32 pairs against its first 16; and the TV-L1 and DeepFlow solves of
    the path's 39 pairs with the grouped products and with one batched
    product, in turns (run on its own; prints only)."""
    import torch

    from tee_optical_flow_torch.config import default_optical_flow_config
    from tee_optical_flow_torch.ops import warp as tw
    from tee_optical_flow_torch.ops.deepflow import (
        deepflow_config_kwargs, deepflow_pairs,
    )
    from tee_optical_flow_torch.ops.imaging import gray_from_clip, img2uint8
    from tee_optical_flow_torch.ops.tvl1 import (
        tvl1_config_kwargs, tvl1_flow_pairs,
    )

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    phase_setup()
    clip, _ = echo_clip(CLIP_FRAMES, CLIP_H, CLIP_W)
    images = img2uint8(gray_from_clip(torch.from_numpy(clip).cuda()))
    shapes = tw.pyramid_shapes(CLIP_H, CLIP_W, 5, 0.5)
    coarse = tw.build_pyramid(images[:-1].contiguous(), shapes)[-1]
    (h, w), (nh, nw) = shapes[-1], shapes[-2]
    ww = torch.from_numpy(tw._resize_weights(w, nw, "cubic")).cuda()
    wh = torch.from_numpy(tw._resize_weights(h, nh, "cubic")).cuda()

    def batched(x):
        return torch.matmul(wh.t(), torch.matmul(x, ww))

    half = coarse.shape[0] // 2
    for name, fn in (("one batched product", batched),
                     (f"groups of {tw.RESIZE_GROUP} (ops/warp._resize)",
                      lambda x: tw.resize_cubic(x, nh, nw))):
        full = fn(coarse)
        d = max(float((full[lo:hi] - fn(coarse[lo:hi])).abs().max())
                for lo, hi in ((0, half), (3, half + 3)))
        log(f"cubic resize {h}x{w} -> {nh}x{nw}, {name}: max|rows of "
            f"{coarse.shape[0]} - the same {half} alone (from 0 and from "
            f"3)| = {d}")
    cfg = default_optical_flow_config()
    kw = deepflow_config_kwargs(cfg)
    whole = deepflow_pairs(images[:-1], images[1:], **kw)
    part = deepflow_pairs(images[:half], images[1:half + 1], **kw)
    log(f"deepflow_pairs: max|pairs of {whole.shape[0]} - {half} alone| = "
        f"{float((whole[:half] - part).abs().max())} px")

    # what the grouped products cost: the path's solves (39 pairs) with
    # them and with one batched product per axis, in turns
    def one_product(img, h, w, method):
        out = img
        if img.shape[2] != w:
            out = torch.matmul(out, torch.from_numpy(tw._resize_weights(
                img.shape[2], w, method)).to(img.device))
        if img.shape[1] != h:
            out = torch.matmul(torch.from_numpy(tw._resize_weights(
                img.shape[1], h, method)).to(img.device).t(), out)
        return out.contiguous()

    frames = np.concatenate([clip, np.repeat(clip[-1:], 7, axis=0)])
    pairs = img2uint8(gray_from_clip(torch.from_numpy(frames).cuda()))
    for name, solve, skw in (
            ("tvl1_flow_pairs", tvl1_flow_pairs, tvl1_config_kwargs(cfg)),
            ("deepflow_pairs", deepflow_pairs, kw)):
        times = {"grouped": [], "batched": []}
        solve(pairs[:-1], pairs[1:], **skw)
        for way in ("batched", "grouped", "grouped", "batched"):
            with (substituted(tw, "_resize", one_product)
                  if way == "batched" else contextlib.nullcontext()):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                solve(pairs[:-1], pairs[1:], **skw)
                torch.cuda.synchronize()
            times[way].append(time.perf_counter() - t0)
        log(f"{name} over {pairs.shape[0] - 1} pairs: resizes in groups "
            + ", ".join(f"{t:.3f}" for t in times["grouped"])
            + " s; one batched product " + ", ".join(
                f"{t:.3f}" for t in times["batched"]) + " s")
    return 0


def unet_algorithms() -> int:
    """UNet (default widths, batch BASELINE_BATCH, float32, TF32 off) at
    256, 512 and 1024 on the card: ms per forward (CUDA events), peak
    memory, and the device kernels a 256 forward spends its time in
    (torch.profiler), with cuDNN's heuristics and with cudnn.benchmark
    (run on its own; prints only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tee_optical_flow_torch.models import baselines as tb

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    phase_setup()
    for benchmark in (False, True):
        torch.backends.cudnn.benchmark = benchmark
        for size in (256, 512, 1024):
            torch.manual_seed(BASELINE_SEED)
            net = tb.UNet().cuda().eval()
            x = torch.randn(BASELINE_BATCH, 3, size, size, device="cuda")
            with torch.no_grad():
                torch.cuda.reset_peak_memory_stats()
                net(x)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() / 1e9
                ms = cuda_ms(lambda: net(x), 3)
                log(f"UNet {size}, cudnn.benchmark={benchmark}: {ms:.3f} ms "
                    f"per batch of {BASELINE_BATCH}, peak {peak:.2f} GB")
                if size == 256:
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        net(x)
                        torch.cuda.synchronize()
                    by = {}
                    for e in prof.events():
                        if e.device_type == torch.autograd.DeviceType.CUDA:
                            c, t = by.get(e.name, (0, 0.0))
                            by[e.name] = (c + 1,
                                          t + e.time_range.elapsed_us() / 1e3)
                    for n, (c, t) in sorted(by.items(),
                                            key=lambda kv: -kv[1][1])[:4]:
                        log(f"  {t:9.2f} ms {c:7d}x {n[:90]}")
    torch.backends.cudnn.benchmark = False
    return 0


def compressed_gamma_check() -> int:
    """phase_cohort (for its dataset) and phase_compressed_gamma alone on
    the 480x640 clip, after the kernels' build: a shorter call than the
    whole smoke, for work on this phase."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    phase_setup()
    clip, truth = echo_clip(CLIP_FRAMES, CLIP_H, CLIP_W)
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as workdir:
        layout = phase_cohort(clip, workdir)["layout"]
        t0 = time.perf_counter()
        out, median = phase_compressed_gamma(clip, truth, workdir, layout)
        log(f"compressed DICOM and gamma ({time.perf_counter() - t0:.1f} s): "
            + json.dumps(dict(out, median=median)))
    return 0


def vitdet_check() -> int:
    """phase_vitdet alone on the 480x640 clip, after the kernels' build:
    a shorter call than the whole smoke, for work on this phase."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    _, has_h5py = phase_setup()
    clip, _ = echo_clip(CLIP_FRAMES, CLIP_H, CLIP_W)
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as workdir:
        log("ViT-Det: " + json.dumps(phase_vitdet(clip, workdir, has_h5py)))
    return 0


def main() -> int:
    import torch

    from tee_optical_flow_torch.io.dicom_write import write_dicom_clip

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card, has_h5py = phase_setup()
    clip, truth = echo_clip(CLIP_FRAMES, CLIP_H, CLIP_W)
    records = phase_kernels(clip, truth)
    labelling = phase_labelling()
    attention = phase_attention()
    k1_args, k1_calls, k3_args, k3_calls = {}, {}, {}, {}
    k2_args, k2_calls, sam_labels = {}, {}, []
    clips = {"TVL1": (clip, truth), "deepflow": (clip, truth),
             "TVL1 600x800": echo_clip(K2_FRAMES, K2_H, K2_W),
             "SAM": (clip, truth)}
    recorders = {
        "TVL1": lambda: record_tvl1("tvl1_outer_loop", K1_SHAPES, k1_args,
                                    k1_calls),
        "deepflow": lambda: record_k3(k3_args, k3_calls),
        "TVL1 600x800": lambda: record_tvl1("tvl1_block_loop", (K2_SHAPE,),
                                            k2_args, k2_calls, every=True),
        "SAM": contextlib.nullcontext}
    seg = sam_segmentor(sam_labels)
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(scratch, exist_ok=True)
    results = {}
    with tempfile.TemporaryDirectory(dir=scratch) as workdir:
        for name in PATHS:
            frames, flow = clips[name]
            n, h, w = frames.shape
            dcm = os.path.join(workdir, f"echo_synthetic_{h}x{w}.dcm")
            if not os.path.exists(dcm):
                write_dicom_clip(
                    dcm, np.repeat(frames[..., None], 3, axis=-1),
                    frame_rate=FPS, pixel_spacing=SPACING_CM)
            results[name] = phase_path(
                name, dcm, frames, flow, has_h5py, workdir, recorders[name],
                seg if PATHS[name]["mode"] != "otsu" else None)
            if name == "SAM":
                sam_stages = phase_sam_masks(sam_labels[-1],
                                             results[name][4]["masks"], dcm,
                                             seg)
        cohort = phase_cohort(clip, workdir)
        layout = cohort.pop("layout")
        analysis = phase_peak_plots(layout)
        config5 = phase_cli(clip, workdir, has_h5py)
        compressed, gamma_median = phase_compressed_gamma(clip, truth,
                                                          workdir, layout)
        del layout
    del seg, sam_labels
    k1 = phase_k1(k1_args, k1_calls)
    k3 = phase_k3(k3_args, k3_calls)
    k2 = phase_k2(k2_args, k2_calls)
    del k1_args, k3_args, k2_args
    phase_saliency(clip)
    with tempfile.TemporaryDirectory(dir=scratch) as workdir:
        t0 = time.perf_counter()
        mesh = phase_mesh(clip, truth, workdir)
        mesh_s = time.perf_counter() - t0
    sam = phase_sam(clip)
    with tempfile.TemporaryDirectory(dir=scratch) as workdir:
        train = phase_train(clip, workdir, has_h5py)
    with tempfile.TemporaryDirectory(dir=scratch) as workdir:
        t0 = time.perf_counter()
        train_mesh = phase_train_mesh(clip, workdir, has_h5py)
        train_mesh_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(dir=scratch) as workdir:
        vitdet = phase_vitdet(clip, workdir, has_h5py)
    t0 = time.perf_counter()
    baselines = phase_baselines()
    baselines_s = time.perf_counter() - t0
    main_counts = results["TVL1"][0]
    df_counts = results["deepflow"][0]
    k2_counts = results["TVL1 600x800"][0]
    finest = f"{CLIP_H}x{CLIP_W}"
    df_device = results["deepflow"][3]["deepflow.cu"]
    records["sor_sweeps"] = dict(
        k3[finest], levels={k: v for k, v in k3.items() if k != finest},
        clip_device_ms=sum(t for _, t in df_device.values()),
        clip_device_launches=sum(c for c, _ in df_device.values()),
        mesh_path_launches={
            k: v["launches"] for k, v in mesh["deepflow"].items()
            if k.startswith("shards_")})
    log(f"K3 per DeepFlow clip: {records['sor_sweeps']['clip_device_ms']:.2f}"
        f" ms of device time over "
        f"{records['sor_sweeps']['clip_device_launches']} device launches "
        f"({df_counts['sor_sweeps']} calls); device launches per call "
        + ", ".join(f"{k} {v['device_launches']}" for k, v in k3.items()))
    records["tvl1_inner_block"] = dict(
        k2[0.01], eps0=k2[0.0], k2_alone=k2["k2_alone"],
        path_calls=k2_counts["tvl1_block_loop"],
        clip_device_ms=k2["clip_device_ms"],
        clip_device_launches=k2["clip_device_launches"])
    records["median_filter_5x5"] = dict(
        gamma_median, k2_shape=k2["median"],
        k2_path_launches=k2_counts["median_filter_5x5"])
    coarsest = K1_SHAPES[-1]
    records["tvl1_outer_loop"] = dict(
        k1[(K1_SHAPES[0], 0.01)], eps0=k1[(K1_SHAPES[0], 0.0)],
        barrier_us=k1["barrier_us"],
        levels={f"{coarsest[0]}x{coarsest[1]}": dict(
            k1[(coarsest, 0.01)], eps0=k1[(coarsest, 0.0)])},
        true_flow=records["tvl1_outer_loop"],
        sam_path_launches=results["SAM"][0]["tvl1_outer_loop"],
        config4_path_launches=cohort["launches"],
        config5_path_launches=config5["launches"],
        vitb_path_launches=vitdet.pop("launches"),
        mesh_path_launches={k: v["launches"] for k, v in mesh["TVL1"].items()
                            if k.startswith("shards_")})
    k2_path = f"K2: otsu+TVL1 {K2_FRAMES}x{K2_H}x{K2_W}"
    kernels = []
    for name, source, replaces, launches, path in (
            ("tvl1_outer_loop", "tvl1.cu",
             "tee_optical_flow_tpu/ops/tvl1_pallas.py:198",
             main_counts["tvl1_outer_loop"], "main: otsu+TVL1 33x480x640"),
            ("median_filter_5x5", "tvl1.cu",
             "tee_optical_flow_tpu/ops/tvl1_pallas.py:248",
             compressed["gamma_median_launches"],
             f"gamma: otsu+TVL1 tvl1_gamma={GAMMA} {CLIP_FRAMES}x{CLIP_H}x"
             f"{CLIP_W} (fused into K1 and the block loop on the other "
             f"paths)"),
            ("tvl1_inner_block", "tvl1.cu",
             "tee_optical_flow_tpu/ops/tvl1_pallas.py:141",
             k2_counts["tvl1_block_loop"],
             f"{k2_path} (tvl1_block_loop calls, one per warp)"),
            ("sor_sweeps", "deepflow.cu",
             "tee_optical_flow_tpu/ops/deepflow_pallas.py:62",
             df_counts["sor_sweeps"], "DeepFlow: otsu+deepflow 33x480x640")):
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tee_optical_flow_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "path": path,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
            **{k: rec[k] for k in ("eps0", "shape", "path_calls", "levels",
                                   "pair_steps", "pair_medians",
                                   "pair_blocks", "k2_alone",
                                   "device_launches", "barrier_us",
                                   "clip_device_ms", "clip_device_launches",
                                   "true_flow", "sam_path_launches",
                                   "config4_path_launches",
                                   "config5_path_launches",
                                   "vitb_path_launches", "k2_shape",
                                   "k2_path_launches", "mesh_path_launches")
               if k in rec},
        })
    # the labelling: its calls in each Otsu path's clip of that shape (fill
    # and size filter; phase_path asserts them and their device launches)
    for (n, h, w), (counts, path) in zip(LABEL_SHAPES, (
            (main_counts, "main"), (k2_counts, "K2"))):
        kernels.append({
            "name": "connected_components", "route": "cuda",
            "source": "tee_optical_flow_torch/csrc/labelling.cu",
            "replaces": "none: tee_optical_flow_tpu/ops/morphology.py:49 "
                        "(a lax.fori_loop stencil)",
            "launches": counts["connected_components"],
            "path": f"{path}: otsu masks {n}x{h}x{w}, connectivity 1",
            "library_ms": None, **labelling[f"{n}x{h}x{w}"]})
    # the attention at vit_h's and vit_b's shapes; its launches a clip on
    # the vit_b path served through cli.process (one a block and
    # micro-batch)
    for name, rec in attention.items():
        kernels.append({
            "name": "rel_pos_attention", "route": "cuda",
            "source": "tee_optical_flow_torch/csrc/relpos_attention.cu",
            "replaces": "none: the JAX package leaves the attention to XLA "
                        "(tee_optical_flow_tpu/models/image_encoder.py); "
                        "plain version models/image_encoder.RelPosAttention"
                        "._attend",
            "launches": vitdet["vit_b_served"]["bfloat16"][
                "attention_launches"],
            "path": f"{name} attention; launches: vit_b bfloat16 "
                    f"through cli.process, one clip",
            **rec})
    for name, (_, clip_s, solver_s, _, _) in results.items():
        log(f"{name}: clip_s {clip_s:.3f} solver_s {solver_s:.3f}")
    sam_clip_s = results["SAM"][1]
    log(f"SAM: {json.dumps(sam)}; stages {json.dumps(sam_stages)}; "
        f"clean_mask RVIO_2class {sam_stages['clean_mask_RVIO_2class_s']:.3f}"
        f" s = {100 * sam_stages['clean_mask_RVIO_2class_s'] / sam_clip_s:.1f}"
        f"% of the {sam_clip_s:.3f} s clip")
    log("config 4: " + json.dumps(
        {k: v for k, v in cohort.items() if k != "row"}))
    log(f"config 4 row: {json.dumps(cohort['row'])}")
    log("config 5: " + json.dumps(config5))
    log("analysis entry points: " + json.dumps(analysis))
    log("training: " + json.dumps(train))
    log(f"training on a mesh ({train_mesh_s:.1f} s): "
        + json.dumps(train_mesh))
    log("ViT-Det: " + json.dumps(vitdet))
    log("compressed DICOM and gamma: " + json.dumps(compressed))
    log(f"mesh ({mesh_s:.1f} s): " + json.dumps(mesh))
    log(f"baselines ({baselines_s:.1f} s): " + json.dumps(baselines))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
