"""DICOM -> masks -> dense flow -> HDF5: the production paths of the
PyTorch port (the JAX package's flow/pipeline.py: Otsu or SAM segmentor
masks, TV-L1 or DeepFlow, on per-frame normalised or saliency flow input).

Parity with reference process_video (calculate_optical_flow.py:478-625):

  * one device copy of the clip feeds the masks (the segmentor runs on
    it) and the flow;
  * TV-L1 and DeepFlow: all N-1 pairs are solved as one batch
    (ops/tvl1.py, ops/deepflow.py), with the primal-dual loops and the SOR
    solve as CUDA kernels on a card;
  * WASE background compensation: the reference subtracts, per flow frame,
    the mean of the frame's flow over every nonzero entry of the *entire*
    clip's background mask stack (calculate_optical_flow.py:649-659);
    algebraically that is sum(flow * B)/count with B = sum_n bkgd_n, which
    ``wase_background`` computes on the device from the segmentor path's
    device 'bkgd' mask (O(HW) per pair instead of O(NHW));
  * companion waveforms (io/waveforms.py) loaded beside the clip and
    saved with it, unless neither ECG nor ART is valid;
  * schema quirks preserved: duplicate-last-flow-frame (:599), flow scaled
    by pixel_spacing*frame_rate (:600), echo stored as rgb2gray floats.
"""

from __future__ import annotations

import contextlib
import logging
import os
import queue
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import OpticalFlowCalculationConfig, default_optical_flow_config
from ..core import (
    as_device_tensor, bucketed_frame_count, bucketed_spatial,
    pad_clip_frames, pad_spatial_edge, resolve_device,
)
from ..exceptions import ConfigurationError, OpticalFlowCalculationError
from ..io.dicom import extract_metadata, read_dicom_clip
from ..io.hdf5 import save_optical_flow_hdf5
from ..io.waveforms import load_all_waveforms
from ..ops.deepflow import (
    deepflow_clip_flow, deepflow_config_kwargs, deepflow_pairs,
)
from ..ops.imaging import gray_from_clip, img2uint8
from ..ops.morphology import unpack_mask_bits
from ..ops.saliency import fine_grained_saliency
from ..ops.tvl1 import tvl1_clip_flow, tvl1_config_kwargs, tvl1_flow_pairs
from ..utils import safe_makedir, trace_stage, tracing
from .segment import (
    clean_mask_device, masks_to_host, predict_movie_thres, segment_labels,
)

logger = logging.getLogger(__name__)

_SEGMENTOR_MODES = ("A4C", "RVIO_2class", "MouseRV_A4C")


def wase_background(flow_pairs: torch.Tensor, bkgd: torch.Tensor
                    ) -> torch.Tensor:
    """Per-pair scalar background = mean of the flow over the nonzero
    entries of the whole clip's bkgd masks (reference semantics, see the
    module docstring), subtracted from each pair, on the flow's device.

    flow_pairs: (P, H, W, 2) float32; bkgd: (N, H, W, 2) bool (the JAX
    package's ``_wase_background``), or (N, H, W), one channel for both
    flow channels (the pipeline's device mask). The sums are float32, as
    in the JAX package, in torch's order."""
    b_sum = bkgd.to(flow_pairs.device, torch.float32).sum(dim=0)
    if b_sum.ndim == 2:
        b_sum = b_sum[..., None]
    nz = (flow_pairs != 0).to(torch.float32)
    total = (flow_pairs * b_sum).sum(dim=(1, 2, 3))
    count = (nz * b_sum).sum(dim=(1, 2, 3))
    bg = torch.where(count > 0, total / count, torch.zeros_like(total))
    return flow_pairs - bg[:, None, None, None]


def wase_background_packed(flow_pairs: torch.Tensor, bkgd_bits,
                           nhw: Tuple[int, int, int]) -> torch.Tensor:
    """wase_background with the (N, H, W) single-channel bkgd mask given
    bit-packed (uint8, numpy packbits order; the JAX package's
    ``_wase_background_packed``)."""
    bkgd = torch.from_numpy(unpack_mask_bits(bkgd_bits, nhw))
    return wase_background(flow_pairs, bkgd)


def compute_clip_flow(images, of_algo: str = "TVL1",
                      config: Optional[OpticalFlowCalculationConfig] = None,
                      device=None) -> torch.Tensor:
    """(N, H, W) flow-input images -> (N-1, H, W, 2) flow, on the device.

    ``images`` is a tensor (its device is used unless ``device`` is
    given) or a host array (sent to ``device``, ``cuda`` by default). With
    ``config.bucket_shapes`` the solve runs at the spatial bucket shape
    (edge-replicate pad, core.py policy) and the padding is sliced off the
    returned flow."""
    config = config or default_optical_flow_config()
    algo = of_algo.lower()
    if algo not in ("tvl1", "deepflow"):
        raise OpticalFlowCalculationError(
            "OF_algo only supports deepflow or TVL1")
    images = as_device_tensor(images, device).to(torch.float32)
    n, h, w = images.shape
    if config.bucket_shapes and config.spatial_bucket > 1:
        hb, wb = bucketed_spatial(h, w, config.spatial_bucket)
        images = pad_spatial_edge(images, hb, wb)
    if algo == "tvl1":
        flow = tvl1_clip_flow(images, config=config)
    else:
        flow = deepflow_clip_flow(images, config=config)
    return flow[:, :h, :w, :]


def compute_clip_flow_sharded(images, mesh, of_algo: str = "TVL1",
                              config: Optional[OpticalFlowCalculationConfig]
                              = None) -> torch.Tensor:
    """Multi-device clip flow: the frame-pair axis split over the mesh's
    'data' axis (parallel/mesh.py). Pairs are independent, so no shard
    needs another's data beyond each pair's own two frames.

    ``images`` (N, H, W), a tensor or a host array, goes to the mesh's
    first data device; with ``config.bucket_shapes`` it is padded to its
    spatial bucket. The pair count is padded to a multiple of the data
    axis by repeating the last pair, each shard's pairs move to its device
    and are solved there (under that device, which the CUDA kernels'
    launches and K1's cooperative grid read) by ``tvl1_flow_pairs`` or
    ``deepflow_pairs`` with the config's keywords, and the shards' flows
    are gathered on the first data device and trimmed to
    (N-1, H, W, 2). Each pair keeps its own state and stop flags in the
    kernels and their plain versions, so a pair's flow does not depend on
    the shard it lands in. The shards are launched one after another from
    this thread: a host synchronisation inside one shard's solve holds
    the next one back."""
    config = config or default_optical_flow_config()
    devices = mesh.data_devices
    images = as_device_tensor(images, devices[0]).to(torch.float32)
    h, w = images.shape[-2:]
    if config.bucket_shapes and config.spatial_bucket > 1:
        hb, wb = bucketed_spatial(h, w, config.spatial_bucket)
        images = pad_spatial_edge(images, hb, wb)
    i0 = images[:-1]
    i1 = images[1:]
    n_pairs = i0.shape[0]
    n_data = len(devices)
    pad = (-n_pairs) % n_data
    if pad:
        i0 = torch.cat([i0, i0[-1:].expand(pad, *i0.shape[1:])])
        i1 = torch.cat([i1, i1[-1:].expand(pad, *i1.shape[1:])])
    if of_algo.lower() == "tvl1":
        solve, kw = tvl1_flow_pairs, tvl1_config_kwargs(config)
    else:
        solve, kw = deepflow_pairs, deepflow_config_kwargs(config)
    per = i0.shape[0] // n_data
    flows = []
    for k, dev in enumerate(devices):
        a = i0[k * per:(k + 1) * per].to(dev).contiguous()
        b = i1[k * per:(k + 1) * per].to(dev).contiguous()
        with torch.cuda.device(dev) if dev.type == "cuda" \
                else contextlib.nullcontext():
            flows.append(solve(a, b, **kw))
    flow = torch.cat([f.to(devices[0]) for f in flows])
    return flow[:n_pairs, :h, :w, :]


class AsyncHDF5Writer:
    """One-deep write-behind for the pipeline's HDF5 stage.

    The gzip-9 write runs on the host, after the device work of its clip;
    h5py releases the GIL around HDF5 library calls, so one writer thread
    lets clip N gzip while clip N+1's masks and flow run on the card. The
    depth-1 queue bounds host memory to two outstanding clips. Failures
    are kept with the originating source path so ``process_folder``'s
    per-file error isolation survives (reference
    calculate_optical_flow.py:276-284).
    """

    def __init__(self) -> None:
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._errors: List[Tuple[str, Exception]] = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            src_path, write_fn = item
            try:
                write_fn()
            except Exception as exc:  # per-file isolation
                logger.error("Error writing output for %s: %s", src_path, exc)
                self._errors.append((src_path, exc))

    def submit(self, src_path: str, write_fn: Callable[[], None]) -> None:
        """Enqueue (blocks while a previous write is still in flight)."""
        self._queue.put((src_path, write_fn))

    def close(self) -> List[Tuple[str, Exception]]:
        """Drain, stop the thread, and return (src_path, error) pairs."""
        self._queue.put(None)
        self._thread.join()
        return self._errors


def process_video(dcm_path: str, save_path: str,
                  segmentor_model: Optional[Callable] = None,
                  verbose: bool = True, mode: str = "A4C",
                  bkgd_comp: str = "none", flipLR: bool = False,
                  no_saliency: bool = False, OF_algo: str = "TVL1",
                  save_mask_subset: Optional[List[str]] = None,
                  include_waveforms: bool = False,
                  waveform_folder: Optional[str] = None,
                  config: Optional[OpticalFlowCalculationConfig] = None,
                  device=None,
                  _clip_override: Optional[np.ndarray] = None,
                  _metadata_override: Optional[Dict] = None,
                  _writer: Optional[AsyncHDF5Writer] = None,
                  _save_fn: Callable = save_optical_flow_hdf5) -> None:
    """Full DICOM -> HDF5 production for one clip, on ``device`` (``cuda``
    unless the caller passes ``"cpu"``).

    The signature and validation follow the JAX package's process_video.
    ``_clip_override`` (an (N, H, W, 3) uint8 clip) and
    ``_metadata_override`` drive the pipeline from memory, with no DICOM:
    the metadata then defaults to no pixel spacing, frame rate or R waves,
    and the patient id and heart rate are empty and 0. A segmentor mode
    runs ``segmentor_model`` (models/sam.make_clip_segmentor's callable,
    or any (N, H, W, 3) uint8 -> (N, H, W) label callable) on the clip.
    ``bkgd_comp="WASE"`` (segmentor modes only) subtracts each pair's
    background flow (``wase_background``) before the unit conversion.
    ``include_waveforms`` loads the clip's ``<base>_II/_ART/_ABP/_PAP/_CVP
    .npy`` companions from ``waveform_folder`` (io/waveforms.py) and saves
    them, unless neither ECG nor ART is valid. With ``_writer`` the write
    is handed to the write-behind thread (process_folder's overlap path);
    write errors then surface at ``_writer.close()``, keyed by
    ``dcm_path``. ``_save_fn`` receives the arguments of
    ``save_optical_flow_hdf5``, which it defaults to; a check can pass its
    own to inspect the arrays where h5py is absent.
    """
    if config is None:
        config = default_optical_flow_config()
    dev = resolve_device(device)

    # reference's mode/flag validation (:509-517)
    if mode == "otsu":
        if bkgd_comp != "none":
            raise ConfigurationError(
                f"bkgd_comp {bkgd_comp} is not supported in mode=otsu, "
                "can only support bkgd_comp=none")
        if save_mask_subset is not None:
            raise ConfigurationError(
                "In mode=otsu, save_mask_subset must be None")
    if bkgd_comp not in ("WASE", "none"):
        raise OpticalFlowCalculationError(
            f"bkgd_comp value must be [WASE, none], got {bkgd_comp}!")
    if mode in _SEGMENTOR_MODES:
        if segmentor_model is None:
            raise ConfigurationError(
                f"mode={mode} requires a segmentor model")
    elif mode != "otsu":
        raise ConfigurationError(
            f"Input for mode must be [A4C, otsu, RVIO_2class, MouseRV_A4C], "
            f"not {mode}.")

    with tracing.clip(dev):
        # --- read + metadata (host) ---
        with trace_stage("dicom_read"):
            if _clip_override is not None:
                nparr = np.asarray(_clip_override)
                ds = None
                metadata = dict(_metadata_override or {
                    "pixel_spacing": None, "frame_rate": None,
                    "R_times": None, "R_wave_data_present": False})
            else:
                ds, nparr = read_dicom_clip(dcm_path)
                metadata = extract_metadata(ds, verbose)

        pixel_spacing = metadata.get("pixel_spacing")
        frame_rate = metadata.get("frame_rate")
        conversion_factor = (1.0 if pixel_spacing is None
                             or frame_rate is None
                             else pixel_spacing * frame_rate)
        nframes = nparr.shape[0]
        if verbose:
            logger.info("Pixel data obtained, of shape: %s", nparr.shape)

        with trace_stage("clip_prep"):
            if flipLR:
                nparr = np.flip(nparr, axis=2)
            # frame-axis bucketing (core.py): last-frame repeats are exact
            # for every real frame's masks and flow; sliced off below
            if config.bucket_shapes and config.frame_bucket > 1:
                nparr = pad_clip_frames(
                    nparr, bucketed_frame_count(nframes, config.frame_bucket))

            # --- one device copy feeds segmentation AND flow. Echo DICOMs
            # are RGB-coded grayscale almost always: when R==G==B, send a
            # single channel (luma of R=G=B is the channel; the segmentor
            # resizes it before broadcasting it to three) ---
            is_gray = (nparr.ndim == 4 and nparr.shape[-1] == 3
                       and np.array_equal(nparr[..., 0], nparr[..., 1])
                       and np.array_equal(nparr[..., 0], nparr[..., 2]))
            clip = np.ascontiguousarray(nparr[..., 0] if is_gray else nparr)
            clip_dev = torch.from_numpy(clip).to(dev)  # pageable: waits
            tracing.count_sync(dev)
            gray = gray_from_clip(clip_dev)  # shared by masks and flow prep

        # --- masks (device, batched) ---
        with trace_stage("segmentation"):
            if mode in _SEGMENTOR_MODES:
                # predict_movie's halves, keeping the device masks for WASE
                labels, label_dev = segment_labels(nparr, segmentor_model,
                                                   _clip_dev=clip_dev)
                masks_dev = clean_mask_device(labels, mode, config=config,
                                              device=label_dev)
                mask_dict = masks_to_host(masks_dev, verbose)
                bkgd_dev = masks_dev["bkgd"][:nframes]
            else:
                mask_dict = predict_movie_thres(nparr, verbose=verbose,
                                                config=config, _gray_dev=gray)
            if nparr.shape[0] != nframes:  # drop frame-bucket padding
                mask_dict = {k: v[:nframes] for k, v in mask_dict.items()}

        # --- flow input prep: per-frame img2uint8 (reference :586-588) or
        # the fine-grained saliency map ---
        with trace_stage("flow_input_prep"):
            images = (img2uint8(gray) if no_saliency
                      else fine_grained_saliency(gray))

        # --- flow (device, all pairs at once) ---
        with trace_stage("optical_flow"):
            # padded (last, last) pairs solve to zero flow; slice them (and
            # the padded echo frames) off before WASE sees the arrays
            flow_pairs = compute_clip_flow(images, OF_algo,
                                           config)[:nframes - 1]
            gray = gray[:nframes]
            if bkgd_comp == "WASE":
                # the segmentor path's bkgd mask, still on the device (otsu
                # mode refuses WASE above)
                flow_pairs = wase_background(flow_pairs, bkgd_dev)
            # unit conversion (:600) and the schema's float16 on the device:
            # half the bytes cross to the host
            cf = torch.tensor(conversion_factor, dtype=torch.float32,
                              device=dev)
            flow_host = (flow_pairs * cf).to(torch.float16).cpu().numpy()
            echo_gray = gray.to(torch.float16).cpu().numpy()
            # the upload of cf and the two copies wait on the card; the
            # last leaves it idle, which ties its span events to the clock
            tracing.count_sync(dev, 3)
            tracing.anchor(dev)

        # --- waveforms (host) ---
        waveform_results: Dict = {}
        if include_waveforms:
            with trace_stage("waveforms"):
                waveform_results = load_all_waveforms(
                    dcm_path, waveform_folder, config, verbose)
            ecg_exists = waveform_results.get("ecg", (False, None))[0]
            art_exists = waveform_results.get("art", (False, None))[0]
            if not ecg_exists and not art_exists:
                include_waveforms = False

        # --- persist (host) ---
        patient_id = ""
        heart_rate = 0
        if ds is not None:
            patient_id = str(ds.get((0x0010, 0x0020), "") or "")
            hr = ds.get((0x0018, 0x1088))
            heart_rate = hr if hr is not None else 0

        def _write() -> None:
            # duplicate last flow frame to clip length (:599)
            flow_arr = np.concatenate([flow_host, flow_host[-1:]], axis=0)
            _save_fn(
                save_path, flow_arr, echo_gray, mask_dict,
                {**metadata, "nframes": nframes},
                waveform_results, mode=mode, no_saliency=no_saliency,
                include_waveforms=include_waveforms, patient_id=patient_id,
                heart_rate=heart_rate,
                sampling_rates={"ecg": config.ecg_sampling_rate,
                                "art": config.art_sampling_rate,
                                "cvp": config.cvp_sampling_rate,
                                "pap": config.pap_sampling_rate},
                save_mask_subset=save_mask_subset, verbose=verbose)

        if _writer is not None:
            _writer.submit(dcm_path, _write)
        else:
            with trace_stage("hdf5_write"):
                _write()


def process_folder(dcm_dir: str, save_dir: str,
                   segmentor_model: Optional[Callable] = None,
                   nchunks: int = 1, chunk_index: int = 0,
                   recalculate: bool = False, verbose: bool = False,
                   overlap_writes: bool = True,
                   **process_kwargs) -> List[str]:
    """Shard a folder of DICOMs and process one chunk, accumulating errors
    instead of dying (reference process_folder,
    calculate_optical_flow.py:243-290). Returns the list of failed paths.

    ``overlap_writes`` (default) hands each clip's gzip-9 HDF5 write to a
    one-deep writer thread so clip N+1's device compute overlaps clip N's
    host write; failed writes still land in the error list under their
    source path."""
    if not os.path.isdir(dcm_dir):
        raise ConfigurationError(f"dcm_folder does not exist: {dcm_dir}")
    safe_makedir(save_dir)
    files = sorted(f for f in os.listdir(dcm_dir)
                   if f.lower().endswith(".dcm"))
    chunks = np.array_split(np.asarray(files, dtype=object), nchunks)
    my_files = list(chunks[chunk_index]) if chunk_index < len(chunks) else []

    writer = AsyncHDF5Writer() if overlap_writes else None
    errors: List[str] = []
    try:
        for fname in my_files:
            dcm_path = os.path.join(dcm_dir, fname)
            save_path = os.path.join(save_dir, fname[:-4] + ".hdf5")
            if os.path.exists(save_path) and not recalculate:
                if verbose:
                    logger.info("%s exists, skipping", save_path)
                continue
            try:
                process_video(dcm_path, save_path, segmentor_model,
                              verbose=verbose, _writer=writer,
                              **process_kwargs)
            except Exception as exc:  # per-file isolation (reference :276-284)
                logger.error("Error processing %s: %s", dcm_path, exc)
                errors.append(dcm_path)
    finally:
        if writer is not None:
            errors.extend(src for src, _ in writer.close())
    return errors
