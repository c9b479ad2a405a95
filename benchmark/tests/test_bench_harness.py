"""Discovery by file name, the result line and the import rule's check."""

import json
import shutil
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(harness.HERE).parent


def benchmark_json():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_every_cell_and_metric_of_benchmark_json_has_its_files():
    bench = benchmark_json()
    for cell in bench["workloads"]:
        found = harness.load_cell(cell["name"])
        assert found["config"] == cell["config"]
        assert found["traffic"] == cell["traffic"]
        assert found["chips"] == cell["chips"]
        assert set(found["limits"]) >= {"decode_diff", "mask_diff"}
    for config in bench["configs"]:
        path = ROOT / config["file"]
        assert path.is_file() and path.stem == config["name"]
        with open(path) as f:
            assert json.load(f)["reduced"] == config["reduced"]
    readers = harness.metric_readers()
    assert {m["name"] for m in bench["per_layer"]} == set(readers)
    for m in bench["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"]


@pytest.fixture
def copy_of_benchmark(tmp_path, monkeypatch):
    """The benchmark's data and readers in a directory of their own, as
    harness.HERE."""
    for kind in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(harness.HERE / kind, tmp_path / kind)
    monkeypatch.setattr(harness, "HERE", tmp_path)
    return tmp_path


def test_a_cell_written_as_a_new_file_is_found(copy_of_benchmark):
    with open(copy_of_benchmark / "traffic" / "clip480.json") as f:
        mix = json.load(f)
    mix["frames"] = 96
    with open(copy_of_benchmark / "traffic" / "clip480_long.json", "w") as f:
        json.dump(mix, f)
    with open(copy_of_benchmark / "workloads"
              / "otsu-tvl1.clip480_long.json", "w") as f:
        json.dump({"config": "otsu-tvl1", "traffic": "clip480_long",
                   "chips": 1, "control": "bf16-reference",
                   "limits": {"decode_diff": 0}}, f)
    assert "otsu-tvl1.clip480_long" in harness.names("workloads")
    cell = harness.load_cell("otsu-tvl1.clip480_long")
    assert cell["traffic_data"]["frames"] == 96
    assert harness.driver(cell).__name__ == "benchmark.drivers.clip"
    with pytest.raises(KeyError):
        harness.load_cell("no-such-cell")


def test_a_metric_written_as_a_new_file_is_read(copy_of_benchmark):
    (copy_of_benchmark / "metrics" / "labelling_rounds.clip.py").write_text(
        "UNIT = 'rounds'\n\ndef read(run):\n"
        "    return run.get('rounds')\n")
    run = {"driver": "clip", "rounds": 2240, "stages": {"dicom_read": 0.04}}
    got = harness.per_layer_metrics(run)
    assert got["labelling_rounds.clip"] == {"value": 2240.0,
                                            "unit": "rounds"}
    assert got["decode_s.clip"] == {"value": 0.04, "unit": "s"}
    # a reader that finds nothing to read leaves its metric out
    assert "labelling_rounds.clip" not in harness.per_layer_metrics(
        {"driver": "clip", "stages": {}})
    assert "mfu.clip" not in got and "tvl1_roofline.clip" not in got


def _run(value, limit, failed=0):
    return {"checks": {"flow_gap_px": harness.check(value, limit)},
            "attempted": 3, "failed": failed,
            "end_to_end": {"clip_s": (1.9, "s"), "setup_s": (20.0, "s")},
            "device": {"platform": "gpu", "kind": "H100", "count": 1,
                       "memory_peak_bytes": 5}}


def test_result_line_is_correct_only_within_every_limit():
    line = harness.result_line(_run(0.01, 0.02), trace=False)
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert line["metrics"]["clip_s"] == {"value": 1.9, "unit": "s"}
    assert harness.result_line(_run(0.03, 0.02), False)["correct"] is False
    assert harness.result_line(_run(0.0, 0.02, failed=1),
                               False)["correct"] is False


def test_forbidden_modules_are_compared_by_whole_top_level_name():
    assert harness.forbidden_loaded(
        ["tee_optical_flow_torch.ops.tvl1", "jaxtyping", "numpy",
         "flaxen"]) == []
    assert harness.forbidden_loaded(
        ["jax.numpy", "tee_optical_flow_tpu.ops", "flax"]) == [
        "flax", "jax", "tee_optical_flow_tpu"]


def test_a_traced_run_reports_the_per_layer_metrics(monkeypatch):
    """The traced path on the CPU, the profiler stood in for (it reads
    the card): the window's first clips run as its span, and every clip
    reader finds its number."""
    from conftest import small_cell

    from benchmark.drivers import clip

    spans_seen = []

    def stand_in(fn, spans):
        fn()
        spans_seen.extend(name for name, *_ in spans.items)
        return {"busy_s": 0.8, "window_s": 1.0,
                "kernels": {"outer_loop_kernel(float*)": (25, 0.04)},
                "breakdown": {"device_ops": [], "idle_gaps": []}}

    monkeypatch.setattr(clip, "profile", stand_in)
    cell = small_cell("otsu-tvl1.clip480")
    cell["traffic_data"]["profiled_clips"] = 2
    run = clip.run(cell, seed=3, seconds=0.0, trace=True, device="cpu",
                   t_start=0.0)
    assert run["attempted"] == 2 and run["profiled_clip_s"] == 0.5
    # the warm-up clip's span and the two profiled clips'
    assert spans_seen.count("clip") == 3 and "segmentation" in spans_seen
    line = harness.result_line(run, trace=True)
    assert line["correct"]
    assert set(line["metrics"]) == {
        "decode_s.clip", "segmentation_s.clip", "optical_flow_s.clip",
        "tvl1_roofline.clip", "idle_share.clip"}
    assert line["metrics"]["idle_share.clip"]["value"] == pytest.approx(20)
    assert 0 < line["metrics"]["tvl1_roofline.clip"]["value"] < 100
    assert line["device"]["busy_s"] == 0.8
