"""The readers of the program's spans and counters: prep_s, labelling_s,
tvl1_warp_s, tvl1_loop_s and resize_s read the run's per-clip stages;
labelling_rounds and host_syncs read the program's counters over its
clips when the run is read. Each returns None where the run, or the
program, holds nothing for it."""

import pytest

from benchmark import harness

SPANS = {"prep_s.clip": "clip_prep", "labelling_s.clip": "labelling",
         "tvl1_warp_s.clip": "tvl1_warp", "tvl1_loop_s.clip": "tvl1_loop",
         "resize_s.clip": "resize"}
COUNTERS = {"labelling_rounds.clip": "labelling_rounds",
            "host_syncs.clip": "host_syncs"}


@pytest.fixture(scope="module")
def readers():
    return harness.metric_readers()


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_span_reader(readers, metric):
    read = readers[metric].read
    stages = {"dicom_read": 0.04, SPANS[metric]: 0.25}
    assert read({"driver": "clip", "stages": stages}) == 0.25
    # a program that does not open the span
    assert read({"driver": "clip", "stages": {"dicom_read": 0.04}}) is None
    assert read({"driver": "train", "stages": stages}) is None
    assert readers[metric].UNIT == "s"


@pytest.fixture
def counters(monkeypatch):
    """The program's counters, as the test sets them."""
    from tee_optical_flow_torch.utils import tracing

    values = {}
    monkeypatch.setattr(tracing, "get_counters", lambda: dict(values))
    return values


@pytest.mark.parametrize("metric", sorted(COUNTERS))
def test_counter_reader(readers, counters, metric):
    read = readers[metric].read
    run = {"driver": "clip", "stages": {}}
    counters.update({"clips": 9, COUNTERS[metric]: 9 * 4480})
    assert read(run) == 4480
    counters[COUNTERS[metric]] = 10
    assert read(run) == pytest.approx(10 / 9)
    del counters[COUNTERS[metric]]
    assert read(run) == 0  # counted clips, none of this
    counters["clips"] = 0
    assert read(run) is None
    counters.clear()
    assert read(run) is None
    counters.update({"clips": 9, COUNTERS[metric]: 9})
    assert read({"driver": "train"}) is None
    assert readers[metric].UNIT == {"labelling_rounds.clip": "rounds",
                                    "host_syncs.clip": "count"}[metric]


@pytest.mark.parametrize("metric", sorted(COUNTERS))
def test_counter_reader_without_counters_in_the_program(readers, monkeypatch,
                                                        metric):
    """A program whose tracing module has no counters gives no reading,
    and no error."""
    from tee_optical_flow_torch.utils import tracing

    monkeypatch.delattr(tracing, "get_counters")
    assert readers[metric].read({"driver": "clip", "stages": {}}) is None


def test_counters_of_a_cpu_clip(readers):
    """One small clip through the program on the CPU: the rounds of its
    two labellings per clip, and no wait on a card."""
    from conftest import run_small

    from tee_optical_flow_torch.utils import tracing

    before = tracing.get_counters()
    run_small("otsu-tvl1.clip480")
    after = tracing.get_counters()
    clips = after["clips"] - before.get("clips", 0)
    rounds = after["labelling_rounds"] - before.get("labelling_rounds", 0)
    assert clips >= 1 and rounds == clips * 2 * 2 * (64 + 96)
    assert after.get("host_syncs", 0) == before.get("host_syncs", 0)
    got = readers["labelling_rounds.clip"].read({"driver": "clip"})
    assert got == after["labelling_rounds"] / after["clips"]
