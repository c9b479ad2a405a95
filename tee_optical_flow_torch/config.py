"""The configurations of the PyTorch port.

Copies of the JAX package's ``OpticalFlowCalculationConfig``, its
analysis-side configurations (``CardiacCycleConfig``,
``VisualizationConfig``, ``ProcessingConfig``, ``PeakDetectionConfig``,
``AnalysisConfig``, ``CardiacCycleMethodConfig``), the run bundle
``PipelineConfig`` with its ``DeviceConfig`` and ``validate_pipeline_config``,
the fine-tuning run's ``TrainConfig``, their preset factories and the JSON
helpers (``config.py:28-477`` there). The fields, names and defaults are
the same, so a JSON written by the JAX package's ``to_json`` (a
``PipelineConfig`` file or a training run's ``args.json``) loads here
field for field, and back.

``tvl1_use_pallas`` keeps its name for that compatibility. In the port it
selects the TPU reference's per-size choice of stopping rule
(``ops/tvl1.per_iteration_stop``); both rules run CUDA kernels on a card.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, List, Literal, Optional, Tuple

from .exceptions import ConfigurationError


def _asdict(cfg: Any) -> Any:
    if is_dataclass(cfg):
        return {f.name: _asdict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [_asdict(v) for v in cfg]
    return cfg


# keys whose FIELD was renamed because its meaning changed: silently
# ignoring them (the unknown-key rule) or silently remapping them would
# both mis-run a persisted config, so they fail loudly with migration
# guidance instead
_RETIRED_KEYS = {
    "deepflow_iterations":
        "renamed to deepflow_sor_iterations in round 5 — the DeepFlow "
        "solver moved from damped Jacobi (this key counted TOTAL "
        "iterations) to red-black SOR (the new key counts sweeps PER "
        "psi round, x deepflow_psi_iterations rounds). Re-tune: the "
        "production default is deepflow_sor_iterations=12 with "
        "deepflow_psi_iterations=3.",
}


def _fromdict(cls: type, data: dict) -> Any:
    kwargs = {}
    known = {f.name: f for f in fields(cls)}
    for key, value in data.items():
        if key in _RETIRED_KEYS and key not in known:
            raise ConfigurationError(
                f"config key '{key}': {_RETIRED_KEYS[key]}")
        if key not in known:
            continue  # forward compatible: ignore unknown keys
        ftype = known[key].type
        target = _DATACLASS_FIELDS.get((cls, key))
        if target is not None and isinstance(value, dict):
            value = _fromdict(target, value)
        elif (isinstance(ftype, str) and ftype.startswith("Tuple")
                and isinstance(value, list)):
            value = tuple(value)  # JSON has no tuples
        kwargs[key] = value
    return cls(**kwargs)


class _JsonMixin:
    def to_dict(self) -> dict:
        return _asdict(self)

    def to_json(self, path: Optional[str] = None, **kw) -> str:
        text = json.dumps(self.to_dict(), indent=2, **kw)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    @classmethod
    def from_dict(cls, data: dict):
        return _fromdict(cls, data)

    @classmethod
    def from_json(cls, path_or_text: str):
        if path_or_text.lstrip().startswith("{"):
            data = json.loads(path_or_text)
        else:
            with open(path_or_text) as f:
                data = json.load(f)
        return cls.from_dict(data)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# analysis-side configs (parity with reference optical_flow/config.py)
# ---------------------------------------------------------------------------

@dataclass
class CardiacCycleConfig(_JsonMixin):
    """Cardiac-cycle detection knobs (reference config.py:12-29)."""

    smooth_fraction: float = 0.2
    pad_len: int = 20
    sys_thres: float = 0.9
    dia_thres: float = 0.5
    rr_sys_ratio: float = 0.333
    sys_extension: int = 2
    t_peak_thres: float = 0.5
    t_min_dist: int = 20
    rr_search_range: List[float] = field(default_factory=lambda: [0.2, 0.75])
    low_peak_thres: float = 0.9
    low_min_dist: int = 50
    high_peak_thres: float = 0.9
    high_min_dist: int = 50
    sys_upstroke_multiplier: int = 2
    sys_upstroke_offset: int = 5


@dataclass
class VisualizationConfig(_JsonMixin):
    """Plotting / video knobs (reference config.py:32-59)."""

    save_dir: Optional[str] = None
    show_plot: bool = False
    show_img: bool = False
    save_cc_plot: bool = False
    nbins: int = 1000
    invert_rad_yaxis: bool = False
    invert_long_yaxis: bool = False
    fps: int = 30
    colormap_mag: str = "hot"
    colormap_ang: str = "viridis"
    colormap_rad: str = "bwr"
    colormap_long: str = "BrBG"
    show_peak_annotations: bool = True
    peak_marker_size: int = 8
    peak_marker_style: str = "+"
    peak_annotation_fontsize: int = 8
    peak_annotation_offset: Tuple[float, float] = (1.5, 1.5)
    radial_peak_color: str = "r"
    longitudinal_peak_color: str = "b"
    systolic_peak_color: str = "r"
    diastolic_peak_color: str = "b"
    show_sysdia_shading: bool = False
    true_sysdia_mode: Literal["radial", "longitudinal"] = "radial"
    print_report: bool = False
    return_statistics: bool = False


@dataclass
class ProcessingConfig(_JsonMixin):
    """Data-processing knobs (reference config.py:62-71)."""

    recalculate: bool = True
    verbose: bool = False
    sampling_rate: Optional[int] = None
    ecg_sampling_rate: int = 500
    art_sampling_rate: int = 125
    cvp_sampling_rate: int = 125
    pap_sampling_rate: int = 125


@dataclass
class PeakDetectionConfig(_JsonMixin):
    """Peak detection knobs (reference config.py:74-82)."""

    peak_thres: float = 0.2
    min_dist: int = 5
    pick_peak_by_subset: bool = True
    show_all_peaks: bool = False
    smooth_fraction: float = 0.3
    pad_len: int = 20


@dataclass
class AnalysisConfig(_JsonMixin):
    """Histogram / statistics knobs (reference config.py:85-95)."""

    percentile: int = 99
    perc_lo: int = 1
    perc_hi: int = 99
    av_filter_flag: bool = True
    av_savgol_window: int = 10
    av_savgol_poly: int = 4
    print_report: bool = False
    return_value: bool = True
    nbins: int = 1000


@dataclass
class CardiacCycleMethodConfig(_JsonMixin):
    """Cycle-method selection (reference config.py:98-105)."""

    method: Literal["angle", "area", "ecg", "ecg_lazy", "metadata",
                    "arterial"] = "angle"
    label: str = "rv_inner"
    true_sysdia_mode: Literal["radial", "longitudinal"] = "radial"
    waveform_data: Optional[object] = None
    show_sysdia: bool = False


@dataclass
class OpticalFlowCalculationConfig(_JsonMixin):
    """Flow-production knobs (reference config.py:174-189).

    ``tvl1_*`` fields expose the solver parameters that OpenCV's DualTVL1
    hardcodes; defaults match OpenCV's defaults so EPE comparisons are
    apples-to-apples.
    """

    lambda_value: float = 0.15
    moving_avg_window: int = 4
    moving_avg_threshold: float = 0.49
    min_mask_size: int = 500
    waveform_flatness_threshold: float = 0.05
    pap_max_mean: float = 100.0
    cvp_max_mean: float = 50.0
    cvp_min_mean: float = -10.0
    ecg_sampling_rate: int = 500
    art_sampling_rate: int = 125
    cvp_sampling_rate: int = 125
    pap_sampling_rate: int = 125
    # TV-L1 solver internals (OpenCV DualTVL1 defaults: tau .25, theta .3,
    # 5 scales at step 0.8, 5 warps, 10x30 iterations, 5x5 median)
    tvl1_tau: float = 0.25
    tvl1_theta: float = 0.3
    tvl1_nscales: int = 5
    tvl1_zoom_factor: float = 0.8
    tvl1_warps: int = 5
    tvl1_outer_iterations: int = 10
    tvl1_inner_iterations: int = 30
    # epsilon: OpenCV's early-stop criterion (0 = fixed counts); gamma:
    # OpenCV's illumination term (0 = off, the OpenCV/reference default)
    tvl1_epsilon: float = 0.01
    tvl1_gamma: float = 0.0
    tvl1_median_filtering: bool = True
    tvl1_max_displacement: int = 16
    tvl1_use_pallas: bool = True
    # warp + inter-level flow interpolation: "bicubic" (Catmull-Rom, the
    # IPOL/OpenCV reference's own interpolator, production default) or
    # "bilinear" (hat weights)
    tvl1_interpolation: str = "bicubic"
    # DeepFlow knobs (ops/deepflow.py). deepflow_use_pallas is kept for
    # JSON compatibility only: on a card the K3 kernels run at every
    # level, whatever it says
    deepflow_alpha: float = 8.0
    deepflow_delta: float = 0.5
    deepflow_gamma: float = 5.0
    deepflow_sor_iterations: int = 12
    deepflow_psi_iterations: int = 3
    deepflow_omega: float = 1.6
    deepflow_nscales: int = 5
    deepflow_matching: bool = True
    deepflow_match_radius: int = 4
    deepflow_beta: float = 0.3
    deepflow_fp_iterations: int = 3
    deepflow_max_displacement: int = 16
    deepflow_use_pallas: bool = True
    deepflow_interpolation: str = "bicubic"
    # clip-shape bucketing (core.py): pad N to a multiple of frame_bucket
    # (last-frame repeats, exact, sliced off on output) and the flow
    # solver's H/W to multiples of spatial_bucket (edge-replicate)
    bucket_shapes: bool = True
    frame_bucket: int = 8
    spatial_bucket: int = 32


# ---------------------------------------------------------------------------
# the run bundle of cli/process
# ---------------------------------------------------------------------------

@dataclass
class DeviceConfig(_JsonMixin):
    """Device and dtype policy of a run."""

    # frame-axis data parallelism of the segmentor over data_axis cards
    # (cli/process.load_segmentor: a parallel/mesh.make_mesh mesh of the
    # cards); None -> one card. model_axis > 1 is for the trainer, whose
    # several-card runs are not ported yet
    data_axis: Optional[int] = None
    model_axis: int = 1
    # compute_dtype is the flow solvers' precision (float32 only:
    # validated); model_dtype the segmentor's (cli/process.load_segmentor;
    # "int8": bfloat16 compute on int8 weights, models/quantize.py)
    compute_dtype: str = "float32"
    model_dtype: str = "bfloat16"
    frame_bucket: int = 8
    spatial_bucket: int = 32
    # where the CUDA kernel library is built and kept, so a later run that
    # points here skips nvcc (core.enable_compilation_cache); None ->
    # build/kernels/ in the checkout
    compilation_cache_dir: Optional[str] = None


@dataclass
class TrainConfig(_JsonMixin):
    """SAM fine-tuning run config (parity with finetune-SAM/cfg.py:3-77);
    the trainer writes it as the run directory's ``args.json``."""

    arch: Literal["vit_h", "vit_l", "vit_b", "vit_t"] = "vit_t"
    finetune_type: Literal["vanilla", "adapter", "lora"] = "vanilla"
    num_cls: int = 2
    image_size: int = 1024
    out_size: int = 256
    epochs: int = 200
    b: int = 4                      # batch size (reference flag name)
    lr: float = 1e-4
    weight_decay: float = 0.1
    warmup: bool = True
    warmup_period: int = 200
    poly_power: float = 0.9
    lora_rank: int = 4
    # PEFT placement (reference cfg.py:59-67): which encoder blocks (or
    # vit_t stages) get adapters / LoRA factors; [] = every block for LoRA
    lora_layers: Optional[List[int]] = None
    if_update_encoder: bool = True
    if_encoder_lora_layer: bool = False
    if_decoder_lora_layer: bool = False
    if_encoder_adapter: bool = False
    encoder_adapter_depths: List[int] = field(
        default_factory=lambda: [0, 1, 10, 11])
    if_mask_decoder_adapter: bool = False
    eval_interval: int = 2
    early_stop_patience: int = 20
    dir_checkpoint: str = "checkpoints"
    targets: str = "multi_all"
    seed: int = 0
    # TinyViT layer-wise lr decay (reference tiny_vit_sam.py:655-687,
    # rate 0.8 from build_sam.py:77); 1.0 disables
    layer_lr_decay: float = 1.0
    # data-parallel cards (more than one is not ported yet: the trainer
    # refuses it), gradient accumulation steps, recompute in the backward
    mesh_data_axis: Optional[int] = None
    grad_accum: int = 1
    remat: bool = False


@dataclass
class PipelineConfig(_JsonMixin):
    """Top-level bundle for DICOM->HDF5 production (cli/process --config)."""

    flow: OpticalFlowCalculationConfig = field(
        default_factory=OpticalFlowCalculationConfig)
    processing: ProcessingConfig = field(default_factory=ProcessingConfig)
    device: DeviceConfig = field(default_factory=DeviceConfig)
    # 'otsu' | 'RVIO_2class' | 'A4C' | 'MouseRV_A4C'
    mode: str = "otsu"
    of_algo: Literal["tvl1", "deepflow"] = "tvl1"
    no_saliency: bool = True
    wase: bool = False               # background (WASE) compensation
    include_waveforms: bool = True
    save_mask_subset: Optional[List[str]] = None


# nested-field registry used by _fromdict
_DATACLASS_FIELDS = {
    (PipelineConfig, "flow"): OpticalFlowCalculationConfig,
    (PipelineConfig, "processing"): ProcessingConfig,
    (PipelineConfig, "device"): DeviceConfig,
}


# ---------------------------------------------------------------------------
# preset factories (parity with reference config.py:108-193)
# ---------------------------------------------------------------------------

def default_cardiac_cycle_config() -> CardiacCycleConfig:
    return CardiacCycleConfig()


def default_visualization_config() -> VisualizationConfig:
    return VisualizationConfig()


def default_processing_config() -> ProcessingConfig:
    return ProcessingConfig()


def default_peak_detection_config() -> PeakDetectionConfig:
    return PeakDetectionConfig()


def default_analysis_config() -> AnalysisConfig:
    return AnalysisConfig()


def ecg_gated_config() -> CardiacCycleConfig:
    return CardiacCycleConfig(smooth_fraction=0.2, pad_len=20,
                              rr_sys_ratio=0.333)


def arterial_gated_config() -> CardiacCycleConfig:
    return CardiacCycleConfig(
        smooth_fraction=0.2, pad_len=20,
        low_peak_thres=0.9, low_min_dist=50,
        high_peak_thres=0.9, high_min_dist=50,
    )


def angle_detection_config() -> CardiacCycleConfig:
    return CardiacCycleConfig(smooth_fraction=0.2, pad_len=20)


def area_detection_config() -> CardiacCycleConfig:
    return CardiacCycleConfig(smooth_fraction=0.3, pad_len=20, sys_thres=0.9,
                              dia_thres=0.5)


def default_optical_flow_config() -> OpticalFlowCalculationConfig:
    return OpticalFlowCalculationConfig()


def validate_pipeline_config(cfg: PipelineConfig) -> None:
    """Raise ConfigurationError on inconsistent settings (reference
    calculate_optical_flow.py:509-517 validates mode/labels similarly)."""
    valid_modes = {"otsu", "RVIO_2class", "A4C", "MouseRV_A4C"}
    if cfg.mode not in valid_modes:
        raise ConfigurationError(
            f"mode {cfg.mode!r} not in {sorted(valid_modes)}")
    if cfg.of_algo not in ("tvl1", "deepflow"):
        raise ConfigurationError(
            f"of_algo {cfg.of_algo!r} must be 'tvl1' or 'deepflow'")
    if cfg.flow.lambda_value <= 0:
        raise ConfigurationError("lambda_value must be positive")
    if not (0 < cfg.flow.tvl1_zoom_factor < 1):
        raise ConfigurationError("tvl1_zoom_factor must be in (0, 1)")
    if cfg.flow.tvl1_interpolation not in ("bilinear", "bicubic"):
        raise ConfigurationError(
            "tvl1_interpolation must be 'bilinear' or 'bicubic'")
    if cfg.flow.deepflow_interpolation not in ("bilinear", "bicubic"):
        raise ConfigurationError(
            "deepflow_interpolation must be 'bilinear' or 'bicubic'")
    if cfg.mode == "otsu" and cfg.wase:
        raise ConfigurationError(
            "WASE background compensation needs segmentation masks; "
            "mode=otsu only supports wase=False "
            "(reference calculate_optical_flow.py:509-517)")
    if cfg.device.compute_dtype != "float32":
        raise ConfigurationError(
            "device.compute_dtype: only float32 is supported for the "
            "variational flow solvers")
    if cfg.device.model_dtype not in ("float32", "bfloat16", "int8"):
        raise ConfigurationError(
            "device.model_dtype must be 'float32', 'bfloat16', or 'int8' "
            "(int8 = weight-only quantized kernels, bfloat16 compute)")
