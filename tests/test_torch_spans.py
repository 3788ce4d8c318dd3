"""The port's spans (dan_tpu_torch/utils/profiling.py) and the benchmark's
per-layer metrics that read them, on the CPU.

Off (no torch.profiler session) a span records nothing; on, its records
nest with their parents and units, its profiler range is not of the USER
scope (which the profiler would also draw on the device's timeline), and
the train step, the bench path's detect, Detector.detect_batch and
TTARunner.run_dataset record exactly their spans.  The module-level
functions the benchmark's taps and faults patch are still looked up where
they were.  The readers of benchmark/metrics/ give the expected numbers on
a hand-built TraceView and span list, and None without spans.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dan_tpu_torch.api import Detector
from dan_tpu_torch.config import (
    DANConfig,
    MatchConfig,
    ModelConfig,
    PostprocessConfig,
    PreprocessConfig,
    TrainConfig,
    TTAConfig,
)
from dan_tpu_torch.data.synthetic import synthetic_batch
from dan_tpu_torch.eval.tta import TTARunner
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.tools import bench
from dan_tpu_torch.tools import profile as profile_tool
from dan_tpu_torch.train import loop
from dan_tpu_torch.utils import profiling
from dan_tpu_torch.utils.profiling import SpanRecord, span

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark.harness import read_metric  # noqa: E402
from benchmark.trace import WINDOW_EVENT, TraceView  # noqa: E402

torch.set_num_threads(1)
USER_SCOPE = 7  # torch.autograd.RecordScope.USER_SCOPE
MODEL = ["dan.model.backbone", "dan.model.lfpn", "dan.model.heads"]
TRAIN = (["dan.train.step", "dan.train.h2d", "dan.train.preprocess", "dan.train.match",
          "dan.train.forward"] + MODEL
         + ["dan.train.loss", "dan.train.backward", "dan.train.optimizer"])
DETECT = (["dan.detect", "dan.detect.normalize"] + MODEL
          + ["dan.detect.postprocess", "dan.detect.select", "dan.detect.nms"])


@pytest.fixture(autouse=True)
def _fresh():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(autouse=True)
def _plain_cpu_conv():
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev


def tiny_config() -> DANConfig:
    return DANConfig(
        model=ModelConfig(image_size=64, compute_dtype="float32"),
        preprocess=PreprocessConfig(train_image_size=64, canvas_size=128),
        match=MatchConfig(max_gt=8),
        postprocess=PostprocessConfig(pre_nms_topk=64, max_detections=8),
        tta=TTAConfig(buckets=(64, 128), scales=(0.5, 1.5), extra_scale_small_images=0.0,
                      max_pixels=1e9),
        train=TrainConfig(batch_size=2, learning_rate=1e-3, hnm_min_negatives=8,
                          lr_boundaries=(1000,), lr_factors=(1.0, 0.1)),
    )


def profiled(fn):
    """fn() inside a CPU torch.profiler session -> (its result, the session)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def names(records=None):
    return [r.name for r in (profiling.recorded() if records is None else records)]


# -- the primitive ---------------------------------------------------------------


def test_span_off_records_nothing_and_allocates_no_span():
    @span("dan.test.fn")
    def fn(x):
        return x + 1

    with span("dan.test.a"):
        with span("dan.test.b", unit=3):
            assert fn(1) == 2
    assert span("dan.test.a") is span("dan.test.a")
    assert span("dan.test.a", unit=5) is span("dan.test.a")
    assert profiling.recorded() == []
    assert profiling._stack.open == []
    _, prof = profiled(lambda: torch.ones(2) + 1)
    assert not [e for e in prof.events() if e.name.startswith("dan.")]


def test_span_on_nests_with_parents_and_units():
    @span("dan.test.fn")
    def fn():
        return torch.ones(3).sum()

    def run():
        with span("dan.test.root", unit=7):
            with span("dan.test.child"):
                fn()
            with span("dan.test.image", unit=2):
                fn()
        with span("dan.test.other"):
            pass

    profiled(run)
    recs = profiling.recorded()
    assert names(recs) == ["dan.test.root", "dan.test.child", "dan.test.fn",
                           "dan.test.image", "dan.test.fn", "dan.test.other"]
    by = {r.id: r for r in recs}
    assert [r.parent for r in recs] == [None, "dan.test.root", "dan.test.child",
                                        "dan.test.root", "dan.test.image", None]
    assert all(r.parent_id is None or by[r.parent_id].name == r.parent for r in recs)
    assert [r.unit for r in recs] == [7, 7, 7, 2, 2, None]
    assert all(r.start_ns <= r.end_ns and r.device_ms is None for r in recs)
    root = recs[0]
    assert all(root.start_ns <= r.start_ns and r.end_ns <= root.end_ns for r in recs[1:5])
    assert profiling._stack.open == []
    profiling.reset()
    assert profiling.recorded() == []


def test_span_profiler_events_are_not_user_scope():
    def run():
        with span("dan.test.outer"):
            with span("dan.test.inner"):
                torch.ones(4).add_(1)

    _, prof = profiled(run)
    ours = [e for e in prof.events() if e.name.startswith("dan.")]
    assert sorted(e.name for e in ours) == ["dan.test.inner", "dan.test.outer"]
    assert all(e.scope != USER_SCOPE for e in ours)
    inner = next(e for e in ours if e.name == "dan.test.inner")
    assert inner.cpu_parent is not None and inner.cpu_parent.name == "dan.test.outer"


def test_span_records_are_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)

    def run():
        for _ in range(5):
            with span("dan.test.x"):
                pass

    profiled(run)
    assert names() == ["dan.test.x"] * 3


def test_span_closes_when_the_body_raises():
    def run():
        with pytest.raises(ValueError):
            with span("dan.test.raises"):
                raise ValueError("x")

    profiled(run)
    assert names() == ["dan.test.raises"] and profiling._stack.open == []


# -- the program's spans -----------------------------------------------------------


@pytest.fixture(scope="module")
def train_state():
    cfg = tiny_config()
    return loop.create_train_state(cfg, 0, "cpu"), synthetic_batch(cfg, 2, seed=0)


def test_train_step_records_its_spans_once_a_step_in_order(train_state):
    state, batch = train_state
    first = state.step

    def run():
        loop.train_step(state, batch)
        loop.train_step(state, batch)

    profiled(run)
    recs = profiling.recorded()
    assert names(recs) == TRAIN * 2
    assert [r.unit for r in recs] == [first] * len(TRAIN) + [first + 1] * len(TRAIN)
    parents = {r.name: r.parent for r in recs}
    assert parents["dan.train.step"] is None
    assert {parents[n] for n in TRAIN[1:5] + TRAIN[8:]} == {"dan.train.step"}
    assert {parents[n] for n in MODEL} == {"dan.train.forward"}


def test_train_step_still_calls_the_patched_module_functions(train_state, monkeypatch):
    state, batch = train_state
    called = []
    for name in ("preprocess_and_match", "loss_and_grads", "sgd_update"):
        inner = getattr(loop, name)

        def patched(*a, _inner=inner, _name=name, **k):
            called.append(_name)
            return _inner(*a, **k)

        monkeypatch.setattr(loop, name, patched)
    profiled(lambda: loop.train_step(state, batch))
    assert called == ["preprocess_and_match", "loss_and_grads", "sgd_update"]
    assert names() == TRAIN


def test_train_step_on_a_mesh_spans_its_all_reduces(train_state, tmp_path):
    """One gloo rank in this process: the positive count's and the
    gradients' all-reduce are each a dan.train.allreduce of the step."""
    import torch.distributed as dist

    from dan_tpu_torch.parallel import mesh as pmesh

    state, batch = train_state
    mesh = pmesh.make_mesh(device="cpu", backend="gloo", rank=0, world_size=1,
                           init_method=f"file://{tmp_path}/pg")
    try:
        profiled(lambda: loop.train_step(state, pmesh.shard_batch(batch, mesh), mesh=mesh))
    finally:
        dist.destroy_process_group()
    got = names()
    i = got.index("dan.train.forward")
    assert got == (TRAIN[:4] + ["dan.train.allreduce"] + TRAIN[4:-1]
                   + ["dan.train.allreduce", "dan.train.optimizer"])
    assert i == 5 and {r.parent for r in profiling.recorded()
                       if r.name == "dan.train.allreduce"} == {"dan.train.step"}


@pytest.fixture(scope="module")
def tiny_detector():
    cfg = tiny_config()
    return cfg, DANDetector(cfg.model, torch.Generator().manual_seed(0)).eval()


def test_bench_detect_records_its_spans_and_calls_the_patched_postprocess(
        tiny_detector, monkeypatch):
    cfg, model = tiny_detector
    detect = bench.build_detect_fn(cfg, "cpu")
    images = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (2, 64, 64, 3),
                                                                dtype=np.uint8))
    want = detect(model, images)
    called = []
    inner = bench.postprocess_batch

    def patched(*a, **k):
        called.append(1)
        return inner(*a, **k)

    monkeypatch.setattr(bench, "postprocess_batch", patched)
    (got, _), _ = profiled(lambda: (detect(model, images), detect(model, images)))
    assert called == [1, 1]
    recs = profiling.recorded()
    assert names(recs) == DETECT * 2
    assert [r.unit for r in recs] == [1] * len(DETECT) + [2] * len(DETECT)
    parents = {r.name: r.parent for r in recs}
    assert parents["dan.detect.select"] == parents["dan.detect.nms"] == "dan.detect.postprocess"
    assert parents["dan.model.lfpn"] == parents["dan.detect.normalize"] == "dan.detect"
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_detect_batch_records_its_spans(tiny_detector):
    cfg, model = tiny_detector
    det = Detector(model, cfg, "cpu")
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 255, (50, 60, 3), dtype=np.uint8) for _ in range(2)]
    want = det.detect_batch(images)
    got, _ = profiled(lambda: det.detect_batch(images))
    recs = profiling.recorded()
    assert names(recs) == (["dan.detect_batch", "dan.detect_batch.pack",
                            "dan.detect_batch.h2d"] + DETECT + ["dan.detect_batch.d2h"])
    assert {r.unit for r in recs} == {1}
    parents = {r.name: r.parent for r in recs}
    assert parents["dan.detect"] == "dan.detect_batch"
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["bboxes"], w["bboxes"])


def test_run_dataset_records_its_spans(tiny_detector):
    cfg, model = tiny_detector
    runner = TTARunner(model, cfg, device="cpu")
    rng = np.random.default_rng(2)
    items = [(f"img_{i}", rng.integers(0, 255, (40 + 20 * i, 60, 3), dtype=np.uint8))
             for i in range(3)]
    out, _ = profiled(lambda: runner.run_dataset(items, batch_per_device=4, vote_batch=2))
    assert sorted(out) == ["img_0", "img_1", "img_2"]
    recs = profiling.recorded()
    stats = runner.last_run_stats
    count = {n: names(recs).count(n) for n in set(names(recs))}
    assert recs[0].name == "dan.tta.run" and recs[0].parent is None
    assert count["dan.tta.run"] == 1
    assert count["dan.tta.canvas"] == stats["images"] == 3
    assert count["dan.tta.bucket"] == stats["bucket_launches"]
    assert count["dan.tta.vote"] == stats["vote_launches"]
    assert count["dan.tta.fetch"] == stats["bucket_launches"] + stats["vote_launches"]
    assert [r.unit for r in recs if r.name == "dan.tta.canvas"] == [0, 1, 2]
    assert {r.parent for r in recs if r.name.startswith("dan.tta.")} == {None, "dan.tta.run"}
    assert count["dan.model.lfpn"] == stats["bucket_launches"]


def test_profile_span_table_counts_self_device_time():
    def rec(i, name, parent_id, ms, host_ms):
        return SpanRecord(i, name, None, parent_id, 0, 0, int(host_ms * 1e6), ms)

    recs = [rec(0, "dan.a", None, 10.0, 12.0), rec(1, "dan.b", 0, 3.0, 4.0),
            rec(2, "dan.c", 0, 2.0, 2.0), rec(3, "dan.a", None, 8.0, 9.0),
            rec(4, "dan.b", 3, 4.0, 4.0)]
    rows = {r.name: r for r in profile_tool.span_table(recs)}
    assert list(rows) == ["dan.a", "dan.b", "dan.c"]
    assert (rows["dan.a"].calls, rows["dan.a"].device_ms, rows["dan.a"].self_ms) == (2, 18.0, 9.0)
    assert rows["dan.a"].host_ms == pytest.approx(21.0)
    assert (rows["dan.b"].calls, rows["dan.b"].self_ms) == (2, 7.0)


def test_profile_tta_images_are_seeded_and_sized():
    a, b = profile_tool.tta_images(10), profile_tool.tta_images(10)
    assert [im.shape[:2] for _, im, _ in a] == [profile_tool.TTA_SIZES[i % 8] for i in range(10)]
    assert all(np.array_equal(x[1], y[1]) for x, y in zip(a, b))
    assert not np.array_equal(a[0][1], profile_tool.tta_images(1, seed=14)[0][1])


# -- the benchmark's readers ------------------------------------------------------

def _rec(name, unit, ms, i=0):
    return SpanRecord(i, name, None, None, unit, 0, 1, ms)


def train_view():
    """Two steps in a 10-s window: waits at 1.5, 2.5 (step 0), 6.0 and 7.0
    (a synchronous copy, step 1) count, 9.0 (outside) and the async copy
    do not; idle gaps (1.5, 2) under dan.train.h2d, (5, 5.5) under
    dan.train.step, (0.9, 1.0) under no span."""
    host = [("dan.train.step", 1, 4), ("dan.train.h2d", 1, 2), ("dan.train.step", 5, 8),
            ("cudaStreamSynchronize", 1.5, 1.6), ("cudaDeviceSynchronize", 2.5, 2.6),
            ("cudaEventSynchronize", 6.0, 6.1), ("cudaMemcpy", 7.0, 7.2),
            ("cudaStreamSynchronize", 9.0, 9.1), ("cudaMemcpyAsync", 3.0, 3.1)]
    device = [("k", 0, 0.9), ("k", 1.0, 1.5), ("k", 2, 5), ("k", 5.5, 10)]
    events = ([(False, WINDOW_EVENT, 0.0, 10.0)] + [(False, n, s, e) for n, s, e in host]
              + [(True, n, s, e) for n, s, e in device])
    view = TraceView(events, {}, {}, {"steps": 2, "images": 64}, {}, {}, 10.0)
    view.program_spans = [
        _rec("dan.train.h2d", 0, 3.0), _rec("dan.train.h2d", 1, 5.0),
        _rec("dan.train.match", 0, 0.5), _rec("dan.train.match", 1, 0.7),
        _rec("dan.train.optimizer", 0, 1.5), _rec("dan.train.optimizer", 1, 1.7)]
    return view


def detect_view():
    """Three calls: lfpn 10, 20, 30 ms; one wait inside dan.detect, one
    outside; idle (4, 4.5) under dan.detect.postprocess."""
    host = [("dan.detect", 1, 3), ("dan.detect", 3.5, 5), ("dan.detect.postprocess", 4, 5),
            ("dan.detect", 6, 7), ("cudaStreamSynchronize", 4.2, 4.3),
            ("cudaStreamSynchronize", 8, 9)]
    events = ([(False, WINDOW_EVENT, 0.0, 10.0)] + [(False, n, s, e) for n, s, e in host]
              + [(True, "k", 0, 4), (True, "k", 4.5, 10)])
    view = TraceView(events, {}, {}, {"calls": 3, "images": 384}, {}, {}, 10.0)
    view.program_spans = [_rec("dan.model.lfpn", u, ms) for u, ms in
                          ((0, 10.0), (1, 20.0), (2, 30.0))]
    return view


READINGS = [("train_h2d_ms", train_view, 4.0), ("train_match_ms", train_view, 0.6),
            ("train_optim_ms", train_view, 1.6), ("host_waits.train", train_view, 2.0),
            ("program_idle_ms.train", train_view, 500.0), ("lfpn_ms.detect", detect_view, 20.0),
            ("host_waits.detect", detect_view, 1 / 3),
            ("program_idle_ms.detect", detect_view, 500 / 3)]


@pytest.mark.parametrize("metric,view,want", READINGS, ids=[r[0] for r in READINGS])
def test_span_metric_reads_a_hand_built_view(metric, view, want, capsys):
    assert read_metric(metric, view()) == pytest.approx(want)
    if metric.startswith("program_idle_ms"):
        assert "by span" in capsys.readouterr().err


@pytest.mark.parametrize("metric,view", [r[:2] for r in READINGS], ids=[r[0] for r in READINGS])
def test_span_metric_is_none_without_spans(metric, view):
    v = view()
    v.program_spans = []
    v.host = [h for h in v.host if not h[0].startswith("dan.")]
    assert read_metric(metric, v) is None
    off_card = view()  # the CPU: no device ms, no device events
    off_card.program_spans = [dataclasses.replace(r, device_ms=None)
                              for r in off_card.program_spans]
    off_card.device = []
    assert read_metric(metric, off_card) is None


def test_span_metrics_read_the_program_records(tiny_detector):
    """Without a hand-built list the readers take profiling.recorded(): on
    the CPU the records carry no device ms, so the readers give None."""
    cfg, model = tiny_detector
    detect = bench.build_detect_fn(cfg, "cpu")
    profiled(lambda: detect(model, torch.zeros((1, 64, 64, 3), dtype=torch.uint8)))
    view = TraceView([], {}, {}, {"calls": 1}, {}, {}, 1.0)
    assert read_metric("lfpn_ms.detect", view) is None
    assert [r.name for r in view.program_spans] == DETECT
