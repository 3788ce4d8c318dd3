"""Data parallelism of the port without the JAX package: the mesh helpers,
the sharded TTA run, the three legs of tools/dryrun_multichip.py (and its
card default), the launcher's hang guards, TrainPipeline's start step and
rank rows, the prefetch stream's thread, and the max_pending default.

Ranks are spawned processes on the CPU with gloo, one thread each, meeting
at a file:// init method under the test's tmp_path.  They import this
module, which imports no JAX, for the rank functions defined here.  The
sharded TTA run is held bit for bit against the one-rank run at the same
batch_per_device: each rank's launches are those of the one-rank run.
"""
import contextlib
import datetime
import inspect
import os
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dan_tpu_torch.api import Detector
from dan_tpu_torch.config import MeshConfig
from dan_tpu_torch.data import pipeline
from dan_tpu_torch.data.pipeline import (
    PREFETCH_THREAD,
    TrainPipeline,
    device_prefetch,
    iter_prefetch,
)
from dan_tpu_torch.data.synthetic import synthetic_batch
from dan_tpu_torch.data.widerface import load_split
from dan_tpu_torch.eval import __main__ as eval_cli
from dan_tpu_torch.eval.tta import TTARunner, plan_variant_buckets
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.parallel import mesh as pmesh
from dan_tpu_torch.parallel.spawn import spawn
from dan_tpu_torch.tools import dryrun_multichip as dry
from dan_tpu_torch.train.loop import create_train_state, train_step

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "mini_wider")
TIMEOUT = 240  # seconds a launch may take here before it fails


# -- rank functions (spawned: module level, no JAX) ---------------------------


def plain_conv_rank(fn, rank, world_size, init_method, *args):
    """fn on a rank whose CPU convolutions, like its parent's in the JAX
    parity tests, take PyTorch's plain path (oneDNN off): spawn
    functools.partial(plain_conv_rank, fn)."""
    torch.backends.mkldnn.enabled = False
    return fn(rank, world_size, init_method, *args)


def _mesh(rank, world_size, init_method, timeout=60):
    return pmesh.make_mesh(device="cpu", backend="gloo", rank=rank, world_size=world_size,
                           init_method=init_method,
                           timeout=datetime.timedelta(seconds=timeout))


def replicate_rank(rank, world_size, init_method, cfg):
    """A state seeded with the rank, then place_replicated; and the rank's
    rows of a global batch."""
    mesh = _mesh(rank, world_size, init_method)
    try:
        state = create_train_state(cfg, seed=rank, device="cpu")
        state.step = 10 + rank
        with torch.no_grad():
            for buf in state.momentum.values():
                buf.fill_(float(rank + 1))
        before = dry.params_digest(state)
        pmesh.place_replicated(state, mesh)
        batch = synthetic_batch(cfg, cfg.train.batch_size, seed=3)
        return {"before": before, "after": dry.params_digest(state), "step": state.step,
                "rows": pmesh.shard_batch(batch, mesh),
                "sum": pmesh.all_reduce_sum(torch.tensor(rank + 1), mesh).item(),
                "gathered": pmesh.gather_objects({"rank": rank}, mesh)}
    finally:
        mesh.close()


def raise_rank(rank, world_size, init_method):
    """Rank 1 raises; rank 0 waits for it in an all-reduce."""
    mesh = _mesh(rank, world_size, init_method, timeout=300)
    if rank == 1:
        raise ValueError("rank 1 gives up")
    dist.all_reduce(torch.ones(1))


def nan_rank(rank, world_size, init_method, cfg, model_dir):
    """One DP step under debug_nans with a NaN in backbone.conv3_1's weight
    on rank 1 only: what the step raised, or None after the checkpoint the
    train CLI would then write."""
    from dan_tpu_torch.ckpt import train_state as ckpt

    with _mesh(rank, world_size, init_method) as mesh:
        state = create_train_state(cfg, 0, mesh.device)
        pmesh.place_replicated(state, mesh)
        if rank == 1:
            with torch.no_grad():
                state.model.get_parameter("backbone.conv3_1.weight").view(-1)[0] = float("nan")
        batch = pmesh.shard_batch(synthetic_batch(cfg, cfg.train.batch_size, seed=0), mesh)
        try:
            train_step(state, batch, mesh=mesh, debug_nans=True)
        except FloatingPointError as e:
            return str(e)
        ckpt.save(model_dir, state.step, state, mesh)
        return None


def tf32_legs_rank(rank, world_size, init_method, model_dir):
    """dryrun_multichip's three legs on a rank whose caller let TF32 run
    everywhere, with the preprocessing and the loss of every train step
    recorded: (the rank's report, the TF32 and cuDNN deterministic flags
    each of them ran under)."""
    from dan_tpu_torch.train import loop

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    seen = []

    def spy(fn):
        def call(*args, **kwargs):
            seen.append((fn.__name__, torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.deterministic))
            return fn(*args, **kwargs)
        return call

    loop.preprocess_and_match = spy(loop.preprocess_and_match)
    loop.detection_loss = spy(loop.detection_loss)
    return dry.legs_rank(rank, world_size, init_method, "cpu", None, model_dir), seen


def hang_rank(rank, world_size, init_method):
    """Rank 1 sleeps; rank 0 waits for it in an all-reduce."""
    _mesh(rank, world_size, init_method, timeout=300)
    if rank == 1:
        time.sleep(300)
    dist.all_reduce(torch.ones(1))


# -- the mesh -----------------------------------------------------------------


def test_place_replicated_and_shard_batch(tmp_path):
    cfg = dry.tiny_config(2)
    got = spawn(replicate_rank, 2, (cfg,), timeout=TIMEOUT, workdir=str(tmp_path))
    assert got[0]["before"] != got[1]["before"]  # seeded apart
    assert got[0]["after"] == got[1]["after"] == got[0]["before"]  # rank 0's
    assert [g["step"] for g in got] == [10, 10]
    batch = synthetic_batch(cfg, cfg.train.batch_size, seed=3)
    for r, g in enumerate(got):
        for k, v in batch.items():
            np.testing.assert_array_equal(g["rows"][k], v[8 * r:8 * (r + 1)], err_msg=k)
        assert g["sum"] == 3
        assert g["gathered"] == [{"rank": 0}, {"rank": 1}]


def test_make_mesh_refuses_what_it_cannot_do(tmp_path):
    init = "file://" + str(tmp_path / "pg")
    with pytest.raises(ValueError, match="NCCL runs between CUDA devices"):
        pmesh.make_mesh(device="cpu", rank=0, world_size=1, init_method=init)
    with pytest.raises(ValueError, match="backend must be"):
        pmesh.make_mesh(device="cpu", backend="mpi", rank=0, world_size=1, init_method=init)
    with pytest.raises(ValueError, match="data_parallel_size 2 != world size 1"):
        pmesh.make_mesh(MeshConfig(data_parallel_size=2), device="cpu",
                        backend="gloo", rank=0, world_size=1, init_method=init)
    env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE") if k in os.environ}
    try:
        with pytest.raises(ValueError, match="no rank"):
            pmesh.make_mesh(device="cpu", backend="gloo")
        assert pmesh.torchrun_mesh() is None
    finally:
        os.environ.update(env)
    assert not dist.is_initialized()
    mesh = pmesh.Mesh(rank=1, size=4, device=torch.device("cpu"), backend="gloo")
    assert mesh.rows(8) == slice(2, 4)
    with pytest.raises(ValueError, match="does not split"):
        mesh.rows(6)


def test_a_dead_rank_fails_the_launch_at_once(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        spawn(raise_rank, 2, timeout=TIMEOUT, workdir=str(tmp_path))
    assert time.monotonic() - t0 < 60  # not the collective's 300 s timeout


def test_a_hung_rank_fails_the_launch_at_its_time_limit(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] of 2 still ran after 10"):
        spawn(hang_rank, 2, timeout=10, workdir=str(tmp_path))
    assert time.monotonic() - t0 < 40


# -- the sharded TTA run ---------------------------------------------------------


def tta_items():
    """7 images of sizes that reach both buckets in groups of 1-6 units, so
    chunks end ragged and some ranks' blocks are empty."""
    rng = np.random.default_rng(0)
    return [(f"e/img{i}", rng.integers(0, 255, (int(h), int(w), 3), dtype=np.uint8))
            for i, (h, w) in enumerate([(60, 80), (68, 80), (200, 150), (40, 56),
                                        (64, 48), (120, 90), (30, 200)])]


def expected_launches(items, runner, rank, n, bpd, vote_batch):
    """A rank's bucket and vote launches from the planners: the chunks of
    each (bucket, canvas) group in which its block holds a unit."""
    groups = {}
    for _, img in items:
        for _, bucket, canvas in plan_variant_buckets(*img.shape[:2], runner.config):
            groups[(bucket, canvas)] = groups.get((bucket, canvas), 0) + 1
    per = {b: runner.bucket_chunk(b, n, bpd) // n for b, _ in groups}
    bucket = sum(len(range(rank * per[b], m, n * per[b])) for (b, _), m in groups.items())
    vchunk = runner._vote_chunk(n, vote_batch)
    return bucket, len(range(rank * (vchunk // n), len(items), vchunk))


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_tta_run_is_bit_identical_to_one_rank(n, tmp_path):
    cfg = dry.tiny_eval_config(dry.tiny_config(1))
    model = DANDetector(cfg.model, torch.Generator().manual_seed(0))
    items = tta_items()
    runner = TTARunner(model, cfg, device="cpu")
    want = runner.run_dataset(items, batch_per_device=2, vote_batch=3)
    one = dict(runner.last_run_stats)
    got = spawn(dry.tta_rank, n, ("cpu", None, cfg, model.state_dict(), items, 2, 3),
                timeout=TIMEOUT, workdir=str(tmp_path))
    for rank, g in enumerate(got):
        assert list(g["results"]) == list(want)
        for k in want:
            np.testing.assert_array_equal(g["results"][k]["bboxes"], want[k]["bboxes"], err_msg=k)
            np.testing.assert_array_equal(g["results"][k]["scores"], want[k]["scores"], err_msg=k)
        bucket, vote = expected_launches(items, runner, rank, n, 2, 3)
        assert g["stats"] == dict(one, bucket_launches=bucket, vote_launches=vote)
        assert g["launches"]["nms"] == g["launches"]["bbox_vote"] == 0  # CPU: plain versions
        assert g["ooms"] == 0
    assert sum(g["stats"]["bucket_launches"] for g in got) == one["bucket_launches"]
    assert one["bucket_launches"] == expected_launches(items, runner, 0, 1, 2, 3)[0]


@pytest.mark.parametrize("world_size, n_cards, want", [
    (1, 1, [None]),
    (2, 1, [0.45, 0.45]),
    (3, 1, [0.3, 0.3, 0.3]),
    (4, 4, [None] * 4),
    (3, 2, [0.45, None, 0.45]),  # ranks 0 and 2 share card 0
])
def test_ranks_that_share_a_card_split_its_memory(world_size, n_cards, want):
    got = [dry.card_share(r, world_size, n_cards) for r in range(world_size)]
    assert got == pytest.approx(want)
    for card in range(n_cards):
        shares = [s for r, s in enumerate(got) if r % n_cards == card and s is not None]
        assert sum(shares) <= dry.CARD_SHARE + 1e-12


class _Fetched:
    def numpy(self):
        return None


def test_warmup_takes_the_runs_launch_sizes():
    cfg = dry.tiny_eval_config(dry.tiny_config(1))
    runner = TTARunner(DANDetector(cfg.model), cfg, device="cpu")
    sizes = []

    def vote(boxes, *args):
        sizes.append(("vote", boxes.shape[0]))
        return _Fetched()

    runner._run_bucket = lambda bucket, canvas, *a: sizes.append((bucket, canvas.shape[0]))
    runner._run_vote = vote
    mesh = pmesh.Mesh(rank=1, size=4, device=torch.device("cpu"), backend="gloo")
    assert runner.warmup([(60, 80)], batch_per_device=3, vote_batch=10, mesh=mesh) == 3
    # bucket_chunk(n_dev=4) / 4 units a launch; ceil(10 / 4) images a vote.
    assert sizes == [(64, 3), (128, 3), ("vote", 3)]
    wrong = pmesh.Mesh(rank=0, size=2, device=torch.device("meta"), backend="gloo")
    with pytest.raises(ValueError, match="not the runner's"):
        runner.run_dataset([], mesh=wrong)


def test_dryrun_multichip_three_legs(capsys):
    reports = dry.dryrun_multichip(2, "cpu", timeout=TIMEOUT)
    err = capsys.readouterr().err
    assert err.count("dryrun_multichip(2, cpu): OK") == 3
    r0, r1 = reports
    assert r0["train"] == r1["train"] and r0["train"]["num_pos"] > 0
    assert r0["continuity"][0] == r0["continuity"][1]
    assert r0["digest"] == r1["digest"]
    assert set(r0["dets"]) == {"img0", "img1", "img2", "img3"} and min(r0["dets"].values()) > 0
    for k in r0["results"]:
        np.testing.assert_array_equal(r0["results"][k]["bboxes"], r1["results"][k]["bboxes"])
    assert r0["tta_stats"]["images"] == 4
    # On the CPU no kernel launches: every wrapper takes its plain version.
    assert r0["launches"] == r1["launches"] == dict.fromkeys(dry.KERNEL_COUNTERS, 0)


def test_dryrun_ranks_train_in_float32_arithmetic(tmp_path):
    """The dry run's ranks start with PyTorch's defaults, which let cuDNN
    use TF32, and here matmuls too: each of the legs' three train steps
    runs its preprocessing and its loss (and so its forward and backward)
    with TF32 off and cuDNN deterministic, as train_step sets them for the
    float32 model."""
    (report, seen), = spawn(tf32_legs_rank, 1, (str(tmp_path / "ckpt"),), timeout=TIMEOUT,
                            workdir=str(tmp_path))
    assert dry.tiny_config(1).model.compute_dtype == "float32"
    assert seen == [("preprocess_and_match", False, False, True),
                    ("detection_loss", False, False, True)] * 3
    assert report["continuity"][2] == 0.0


# -- queue-3 repairs: the pipeline's start step, the max_pending default ----------


def _take(pipe, n):
    it = iter(pipe)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


@pytest.mark.parametrize("producers", [1, 3])
def test_pipeline_resumes_at_its_start_step_and_builds_rank_rows(producers):
    records = load_split(FIX, "val")
    cfg = dry.tiny_config(1)
    kw = dict(batch_size=6, seed=5, num_workers=2, num_producers=producers)
    straight = _take(TrainPipeline(records, cfg, **kw), 5)
    resumed = _take(TrainPipeline(records, cfg, start_step=3, **kw), 2)
    halves = [_take(TrainPipeline(records, cfg, start_step=3, rank=r, num_ranks=2, **kw), 2)
              for r in range(2)]
    assert len(records) < 6 * 5  # the run wraps an epoch
    for i, got in enumerate(resumed):
        for k, v in straight[3 + i].items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
            np.testing.assert_array_equal(halves[0][i][k], v[:3], err_msg=k)
            np.testing.assert_array_equal(halves[1][i][k], v[3:], err_msg=k)
    with pytest.raises(ValueError, match="does not split"):
        TrainPipeline(records, cfg, batch_size=6, num_ranks=4)


def test_device_prefetch_feeds_the_same_step():
    cfg = dry.tiny_config(1)
    batches = [synthetic_batch(cfg, 2, seed=s) for s in range(2)]
    a = create_train_state(cfg, 0, "cpu")
    b = create_train_state(cfg, 0, "cpu")
    for host, dev in zip(batches, device_prefetch(iter(batches), "cpu")):
        assert isinstance(dev["canvas"], torch.Tensor) and dev["seed"] is host["seed"]
        ma, mb = train_step(a, host), train_step(b, dev)
        assert float(ma["loss"]) == float(mb["loss"])
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)


def _prefetch_threads(before):
    return [t for t in threading.enumerate() if t.name == PREFETCH_THREAD and t not in before]


@pytest.mark.parametrize("end", ["ran_out", "close", "with", "source_raises"])
def test_prefetch_stream_leaves_no_thread(end):
    """A device_prefetch stream's thread has ended, and has closed the
    generator it drew from, once the stream ran out, once the consumer
    closed it part way (close(), or the end of a `with`), and once the
    generator raised (the error reaches the consumer)."""
    cfg = dry.tiny_config(1)
    closed = []

    def source(n, fail=False):
        try:
            for s in range(n):
                yield synthetic_batch(cfg, 2, seed=s)
            if fail:
                raise ValueError("a bad record")
        finally:
            closed.append(threading.current_thread().name)

    before = set(threading.enumerate())
    if end == "ran_out":
        assert len(list(device_prefetch(source(3), "cpu"))) == 3
    elif end == "close":
        stream = device_prefetch(source(100), "cpu")
        next(stream)
        stream.close()
        assert next(stream, None) is None
    elif end == "with":
        with contextlib.closing(device_prefetch(source(100), "cpu", depth=1)) as stream:
            assert int(next(stream)["seed"][0]) == int(synthetic_batch(cfg, 2, seed=0)["seed"][0])
    else:
        with pytest.raises(ValueError, match="a bad record"):
            list(device_prefetch(source(2, fail=True), "cpu"))
    assert not _prefetch_threads(before)
    assert closed == [PREFETCH_THREAD]


def test_prefetch_close_raises_when_the_thread_does_not_end(monkeypatch):
    """close() waits for the thread for at most PREFETCH_JOIN_S and raises
    if the thread is still running then."""
    monkeypatch.setattr(pipeline, "PREFETCH_JOIN_S", 0.2)
    release = threading.Event()

    def blocked():
        yield 0
        release.wait(30)
        yield 1

    before = set(threading.enumerate())
    stream = iter_prefetch(blocked(), depth=1)
    assert next(stream) == 0
    with pytest.raises(RuntimeError, match="did not end within 0.2 s"):
        stream.close()
    release.set()
    for t in _prefetch_threads(before):
        t.join(30)
    assert not _prefetch_threads(before)


def test_closed_prefetch_stream_draws_nothing_more():
    """Closing a stream whose thread waits on a full queue lets that put
    through and ends the thread before it draws another item."""
    drawn = []

    def source():
        for i in range(100):
            drawn.append(i)
            yield i

    before = set(threading.enumerate())
    stream = iter_prefetch(source(), depth=1)
    assert next(stream) == 0
    deadline = time.monotonic() + 30
    while len(drawn) < 3 and time.monotonic() < deadline:  # 1 queued, 2 waiting to be
        time.sleep(0.01)
    time.sleep(0.2)
    assert drawn == [0, 1, 2]
    stream.close()
    assert drawn == [0, 1, 2] and not _prefetch_threads(before)


def test_max_pending_defaults_read_the_runner_constant(monkeypatch):
    assert inspect.signature(TTARunner.run_dataset).parameters["max_pending"].default \
        == TTARunner.DEFAULT_MAX_PENDING == 32
    monkeypatch.setattr(TTARunner, "DEFAULT_MAX_PENDING", 5)
    _, args = eval_cli.parse_args(["--wider_root", FIX])
    assert args.max_pending == 5
    cfg = dry.tiny_eval_config(dry.tiny_config(1))
    det = Detector(DANDetector(cfg.model), cfg, device="cpu")
    seen = {}
    runner = det._get_tta_runner()
    monkeypatch.setattr(runner, "run_dataset", lambda items, **kw: seen.update(kw) or {})
    det.detect_tta_dataset([])
    assert seen["max_pending"] == 5
    det.detect_tta_dataset([], max_pending=7)
    assert seen["max_pending"] == 7
