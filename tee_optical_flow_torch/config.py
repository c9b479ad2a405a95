"""The flow-production configuration of the PyTorch port.

A copy of the JAX package's ``OpticalFlowCalculationConfig`` and its JSON
helpers (``config.py:28-96,206-302,442`` there). The fields, names and
defaults are the same, so a JSON written by the JAX package's ``to_json``
loads here field for field, and back. TV-L1 has no learned weights: this
configuration is the whole state the flow path carries across.

``tvl1_use_pallas`` keeps its name for that compatibility. In the port it
selects the TPU reference's per-size choice of stopping rule
(``ops/tvl1.per_iteration_stop``); both rules run CUDA kernels on a card.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, fields, is_dataclass
from typing import Any, Optional

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
    known = {f.name for f in fields(cls)}
    for key, value in data.items():
        if key in _RETIRED_KEYS and key not in known:
            raise ConfigurationError(
                f"config key '{key}': {_RETIRED_KEYS[key]}")
        if key not in known:
            continue  # forward compatible: ignore unknown keys
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
    # OpenCV's illumination term (0 = off, the OpenCV/reference default;
    # not yet ported: tvl1_flow_pairs raises for gamma > 0)
    tvl1_epsilon: float = 0.01
    tvl1_gamma: float = 0.0
    tvl1_median_filtering: bool = True
    tvl1_max_displacement: int = 16
    tvl1_use_pallas: bool = True
    # warp + inter-level flow interpolation: "bicubic" (Catmull-Rom, the
    # IPOL/OpenCV reference's own interpolator, production default) or
    # "bilinear" (hat weights)
    tvl1_interpolation: str = "bicubic"
    # DeepFlow knobs: read and written for JSON compatibility; the DeepFlow
    # solver is not yet ported (compute_clip_flow raises for it)
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


def default_optical_flow_config() -> OpticalFlowCalculationConfig:
    return OpticalFlowCalculationConfig()
