"""EPE report of the PyTorch port: its solvers on a CUDA card against the
float64 NumPy oracles, at the production resolution.

    python3 epe_report_torch.py [--out EPE_torch.json] [--pairs 1]

The port's counterpart of epe_report.py (that script drives the JAX
package; this one imports only the port). It measures the bars of
EPE_r05.json (the JAX package's report) for the port:

- ``tvl1_bicubic``: TV-L1 with bicubic warps, epsilon 0 on both sides, so
  both run the same iteration counts (matched iterations);
- ``tvl1_production``: the shipped defaults, bicubic warps and epsilon
  0.01 on both sides, with each case's stopping-noise floor (the oracle
  stopped at 0.01 against the oracle at epsilon 0: the protocol's own
  uncertainty);
- ``deepflow_matching``: the production DeepFlow path (the port's
  cost-volume matches and seed, fed to the oracle as the same
  constraints) at the production fixed-point x psi x SOR schedule.

Content: per class ``--pairs`` pairs (default 1) of smoothed speckle
under a global shift ("textured") and of a synthetic TEE sector
contracting radially ("echo", reported also over its sector and wall
masks); an 8 px border band is excluded everywhere. The solvers run on
the card (``cuda``), the oracles on the host in parallel worker
processes (one per core). Exits non-zero when no CUDA device is present.
Prints one JSON line (the report without its per-case detail) and writes
the report to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

SETTINGS = dict(lam=0.15, tau=0.25, theta=0.3, nscales=5, zoom=0.8,
                warps=5, outer_iters=10, inner_iters=30)
DF_SETTINGS = dict(alpha=8.0, delta=0.5, gamma=5.0, nscales=5, zoom=0.5)
# the production DeepFlow schedule (config.py deepflow_fp_iterations,
# deepflow_psi_iterations, deepflow_sor_iterations, deepflow_omega)
DF_COUNTS = dict(fp_iters=3, psi_iters=3, sor_iters=12, omega=1.6)
SHIFTS = [(2.0, -3.0), (-1.3, 0.8), (4.0, 2.5)]
INTERIOR = 8
THRESHOLD_PX = 0.1
# EPE_r05.json: the same bars measured for the JAX package (on a TPU)
JAX_BARS = {
    "tvl1_bicubic": {"worst_interior_median_px": 0.02857,
                     "worst_wall_masked_p95_px": 0.01426,
                     "worst_sector_masked_p95_px": 0.06329},
    "tvl1_production": {"worst_wall_masked_p95_px": 0.05241,
                        "worst_sector_masked_p95_px": 0.10481,
                        "stopping_noise_floor_sector_p95_px": 0.13047},
    "deepflow_matching": {"worst_sector_masked_p95_px": 0.0118},
}


def _stats(err, mask=None) -> dict:
    sel = np.zeros_like(err, bool)
    sel[INTERIOR:-INTERIOR, INTERIOR:-INTERIOR] = True
    if mask is not None:
        sel &= mask
    e = err[sel]
    return {"median_px": round(float(np.median(e)), 5),
            "p95_px": round(float(np.percentile(e, 95)), 5),
            "p99_px": round(float(np.percentile(e, 99)), 5),
            "max_px": round(float(e.max()), 5)}


def _case(err, masks) -> dict:
    out = {"interior": _stats(err)}
    for name, m in (masks or {}).items():
        out[name] = _stats(err, m)
    return out


def _section(cases: dict) -> dict:
    def worst(region, key):
        vals = [c[region][key] for c in cases.values() if region in c]
        return max(vals) if vals else None

    sec = {"worst_interior_median_px": worst("interior", "median_px"),
           "worst_wall_masked_p95_px": worst("wall", "p95_px"),
           "worst_sector_masked_p95_px": worst("sector", "p95_px")}
    for key in ("wall", "sector"):
        v = sec[f"worst_{key}_masked_p95_px"]
        sec[f"{key}_masked_p95_met"] = None if v is None else v < THRESHOLD_PX
    # a case's own floor: the sector p95 between its two oracle runs
    floored = [c for c in cases.values()
               if "sector" in c.get("stopping_noise_floor", {})]
    if floored:
        sec["stopping_noise_floor_sector_p95_px"] = max(
            c["stopping_noise_floor"]["sector"]["p95_px"] for c in floored)
        sec["sector_p95_within_stopping_noise"] = all(
            c["sector"]["p95_px"]
            <= c["stopping_noise_floor"]["sector"]["p95_px"]
            for c in floored)
    sec["cases"] = cases
    return sec


def _oracle(kind: str, i0, i1, kw: dict):
    """One float64 oracle solve in a worker process: (flow, seconds)."""
    from tee_optical_flow_torch.ops.deepflow_oracle import (
        deepflow_flow_oracle,
    )
    from tee_optical_flow_torch.ops.tvl1_oracle import tvl1_flow_oracle

    t0 = time.perf_counter()
    if kind == "tvl1":
        flow = tvl1_flow_oracle(i0, i1, median_kernel=5, **kw)
    else:
        flow = deepflow_flow_oracle(i0, i1, **kw)
    return flow, time.perf_counter() - t0


def _matches(i0, i1, device):
    """The port's cost-volume matches at the two coarsest levels and its
    coarsest-level seed (deepflow_pairs' matching path), in the oracle's
    ``matches`` / ``init`` form."""
    import torch

    from tee_optical_flow_torch.ops.deepflow import _box_mean, coarse_match
    from tee_optical_flow_torch.ops.warp import build_pyramid, pyramid_shapes

    h, w = i0.shape
    shapes = pyramid_shapes(h, w, DF_SETTINGS["nscales"], DF_SETTINGS["zoom"])
    pyr0 = build_pyramid(torch.from_numpy(i0[None]).to(device), shapes)
    pyr1 = build_pyramid(torch.from_numpy(i1[None]).to(device), shapes)
    nlvl = len(shapes)
    found = {lvl: coarse_match(pyr0[lvl], pyr1[lvl], radius=4)
             for lvl in (nlvl - 1, nlvl - 2)}
    matches = {lvl: tuple(a[0].cpu().numpy() for a in m)
               for lvl, m in found.items()}
    um, vm, conf = found[nlvl - 1]
    ch, cw = shapes[-1]
    fill = max(ch, cw) // 4 + 1
    wsum = _box_mean(conf, fill) + 1e-6
    init = tuple((_box_mean(a * conf, fill) / wsum)[0].cpu().numpy()
                 for a in (um, vm))
    return matches, init


def _solve(fn, i0, i1, device, **kw):
    """The port's solver on the card, timed to completion after a warm-up
    call: (flow, seconds)."""
    import torch

    a = torch.from_numpy(i0[None]).to(device)
    b = torch.from_numpy(i1[None]).to(device)
    fn(a, b, **kw)
    if a.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    flow = fn(a, b, **kw)[0].cpu().numpy()
    return flow, time.perf_counter() - t0


def build_report(h: int, w: int, pairs: int, device) -> dict:
    """Solve every case on ``device`` and with the oracles, and return
    the report (main runs it on the card; a CPU run at a small size
    rehearses the script)."""
    import torch

    from tee_optical_flow_torch.ops.deepflow import deepflow_pairs
    from tee_optical_flow_torch.ops.tvl1 import tvl1_flow_pairs
    from tee_optical_flow_torch.ops.tvl1_oracle import epe
    from tee_optical_flow_torch.synthetic import (
        echo_sector_masks, make_echo_pair, make_textured_pair,
    )

    t_start = time.perf_counter()
    dev = torch.device(device)
    echo_masks = {k: v for k, v in echo_sector_masks(h, w).items()
                  if k in ("sector", "wall")}
    cases = []
    for k in range(pairs):
        i0, i1 = make_textured_pair(k, h, w, SHIFTS[k % len(SHIFTS)])
        cases.append((f"textured_{k}", i0, i1, None))
    for k in range(pairs):
        i0, i1 = make_echo_pair(100 + k, h, w, contraction=0.03 + 0.02 * k)
        cases.append((f"echo_{k}", i0, i1, echo_masks))

    tv_kw = dict(use_median=True, use_pallas=True, interpolation="bicubic",
                 **SETTINGS)
    df_kw = dict(iters=DF_COUNTS["sor_iters"],
                 psi_iters=DF_COUNTS["psi_iters"], omega=DF_COUNTS["omega"],
                 fp_iters=DF_COUNTS["fp_iters"], matching=True,
                 interpolation="bicubic", **DF_SETTINGS)
    ctx = multiprocessing.get_context("spawn")
    jobs = {}
    solved = {}
    with ProcessPoolExecutor(mp_context=ctx) as pool:
        for name, i0, i1, _ in cases:
            for eps in (0.0, 0.01):
                jobs[(name, "tvl1", eps)] = pool.submit(
                    _oracle, "tvl1", i0, i1, dict(epsilon=eps, **SETTINGS))
            matches, init = _matches(i0, i1, dev)
            jobs[(name, "deepflow", None)] = pool.submit(
                _oracle, "deepflow", i0, i1,
                dict(matches=matches, init=init, beta=0.3, **DF_COUNTS,
                     **DF_SETTINGS))
        # the card works while the oracles run on the host
        for name, i0, i1, _ in cases:
            for eps in (0.0, 0.01):
                solved[(name, "tvl1", eps)] = _solve(
                    tvl1_flow_pairs, i0, i1, dev, epsilon=eps, **tv_kw)
            solved[(name, "deepflow", None)] = _solve(
                deepflow_pairs, i0, i1, dev, **df_kw)
            print(f"{name}: solved on the card", flush=True)
        golden = {key: job.result() for key, job in jobs.items()}

    sections = {"tvl1_bicubic": {}, "tvl1_production": {},
                "deepflow_matching": {}}
    seconds = {}
    for name, _, _, masks in cases:
        for sec, key in (("tvl1_bicubic", (name, "tvl1", 0.0)),
                         ("tvl1_production", (name, "tvl1", 0.01)),
                         ("deepflow_matching", (name, "deepflow", None))):
            ours, t_solver = solved[key]
            ref, t_oracle = golden[key]
            sections[sec][name] = _case(epe(ours, ref), masks)
            seconds[f"{sec}/{name}"] = {"solver_s": round(t_solver, 4),
                                        "oracle_s": round(t_oracle, 1)}
        floor = _case(epe(golden[(name, "tvl1", 0.01)][0],
                          golden[(name, "tvl1", 0.0)][0]), masks)
        sections["tvl1_production"][name]["stopping_noise_floor"] = floor
        case = {sec: sections[sec][name] for sec in sections}
        print(f"{name}: {json.dumps(case)}", flush=True)

    report = {
        "metric": "flow_epe_vs_float64_oracles_px",
        "threshold_px": THRESHOLD_PX,
        "solver": "tee_optical_flow_torch",
        "resolution": [h, w],
        "pairs_per_class": pairs,
        "tvl1_settings": SETTINGS,
        "deepflow_settings": {**DF_SETTINGS, **DF_COUNTS},
        "note": (
            "interior = excluding an 8 px border band; 'sector' = inside "
            "the echo fan, 'wall' = the myocardial ring (what the "
            "pipeline's masked analysis reads). Oracles: "
            "ops/tvl1_oracle.py and ops/deepflow_oracle.py (float64 NumPy, "
            "on the host); solvers on the card. jax_bars: the same bars "
            "measured for the JAX package (EPE_r05.json)."),
        "jax_bars": JAX_BARS,
        "seconds": seconds,
        "script_seconds": round(time.perf_counter() - t_start, 1),
    }
    for sec, cases_ in sections.items():
        report[sec] = _section(cases_)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="EPE_torch.json")
    ap.add_argument("--size", type=int, nargs=2, default=(480, 640))
    ap.add_argument("--pairs", type=int, default=1, help="pairs per class")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("epe_report_torch: no CUDA device is available",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    report = {"device": torch.cuda.get_device_name(0), "card": smi,
              **build_report(*args.size, args.pairs, "cuda")}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    sections = ("tvl1_bicubic", "tvl1_production", "deepflow_matching")
    summary = {k: v for k, v in report.items() if k not in sections}
    for sec in sections:
        summary[sec] = {k: v for k, v in report[sec].items() if k != "cases"}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
