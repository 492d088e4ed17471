"""The port's spans (`anystereo_tpu_torch/utils/profiling.py`: `span`,
`record_spans`, `launch_counts`) on the CPU.

- Off (no `record_spans()`), a span is the one shared no-op context and a
  profiler sees no `anystereo/` range.
- The IGEV and the RAFT eval forward at 1x64x128, 2 iterations, give the
  same bits with spans on and off, and each eval step's spans form the
  tree `eval_step` -> `matching`, `cost`, `context`, `gru` x iterations,
  `decode`, one root a step, each child's host interval inside its
  parent's.
- Under a CPU profiler each span's interval placed on the trace's clock
  lies within 100 us of its own `anystereo/<name>` range.
- A training step (with and without remat) and two steps of `train()` on a
  synthetic SceneFlow tree give `train_step` -> `forward` (the model's
  stages under it, one `gru` an iteration), `loss`, `backward`,
  `optimizer`, and `loader_wait` around each batch the trainer waits for.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from anystereo_tpu_torch.config import Config, ModelConfig, TrainConfig, raft_config
from anystereo_tpu_torch.data.augment import AugmentorConfig
from anystereo_tpu_torch.data.datasets import fetch_dataset
from anystereo_tpu_torch.data.loader import PrefetchLoader
from anystereo_tpu_torch.nn.model import build_model
from anystereo_tpu_torch.ops.kernels.lookup import gather_pyramid_aligned
from anystereo_tpu_torch.tools.make_synthetic_datasets import gen_sceneflow
from anystereo_tpu_torch.train import trainer
from anystereo_tpu_torch.train.state import create_train_state
from anystereo_tpu_torch.train.step import make_eval_step, make_train_step
from anystereo_tpu_torch.utils import profiling

B, H, W, ITERS = 1, 64, 128, 2
STAGES = ["matching", "cost", "context"] + ["gru"] * ITERS + ["decode"]
TRACE_TOL_US = 100.0
CONFIGS = {"igev": lambda: ModelConfig(max_disp=32), "raft": raft_config}
SMALL = ModelConfig(max_disp=32, compute_dtype="float32", hidden_dims=(32, 32, 32), n_gru_layers=1)
TRAIN_H, TRAIN_W, TRAIN_Q = 32, 64, 256


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: a parallel test run shares the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _images(seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((B, H, W, 3), generator=g) * 255, torch.rand((B, H, W, 3), generator=g) * 255


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def eval_runs(request):
    """(spans off, spans on over two steps, the records) of one core."""
    step = make_eval_step(build_model(CONFIGS[request.param](), "cpu"), valid_iters=ITERS, device="cpu")
    left, right = _images()
    scale = torch.ones(B)
    off = step(left, right, None, scale)
    with profiling.record_spans() as rec:
        on = [step(left, right, None, scale) for _ in range(2)]
    return off, on, rec.collect()


def _children(records, parent):
    return [r for r in records if r["parent"] == parent["id"]]


def test_off_records_nothing_and_opens_no_range():
    assert profiling.span("gru", i=0) is profiling.span("decode") is profiling._OFF
    step = make_eval_step(build_model(SMALL, "cpu"), valid_iters=1, device="cpu")
    left, right = _images()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(left[:, :32, :64], right[:, :32, :64], None, torch.ones(B))
    assert not [e.name for e in prof.events() if e.name.startswith("anystereo/")]
    with profiling.record_spans() as rec:
        with pytest.raises(RuntimeError, match="already"):
            with profiling.record_spans():
                pass
    assert profiling._recorder is None and rec.collect() == []


def test_spans_leave_the_forward_bit_for_bit(eval_runs):
    off, on, _ = eval_runs
    for out in on:
        assert torch.equal(out, off)


def test_each_eval_step_is_one_tree_of_its_stages(eval_runs):
    _, _, records = eval_runs
    roots = [r for r in records if r["parent"] is None]
    assert [r["name"] for r in roots] == ["eval_step", "eval_step"]
    for root in roots:
        kids = _children(records, root)
        assert [r["name"] for r in kids] == STAGES
        assert [r["attrs"] for r in kids if r["name"] == "gru"] == [{"i": i} for i in range(ITERS)]
        mine = [r for r in records if r["root"] == root["id"]]
        assert len(mine) == 1 + len(STAGES)
        for r in kids:
            assert root["host_ns"][0] <= r["host_ns"][0] <= r["host_ns"][1] <= root["host_ns"][1]
            assert r["stream_ms"] is None and r["launches"] == {}


def test_spans_lie_on_the_profilers_clock():
    step = make_eval_step(build_model(CONFIGS["igev"](), "cpu"), valid_iters=ITERS, device="cpu")
    left, right = _images(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.record_spans() as rec:
            step(left, right, None, torch.ones(B))  # the first ranges of a process start late
            first = rec.collect()
            step(left, right, None, torch.ones(B))
    records = rec.collect(prof)
    assert records[0]["id"] == len(first)
    ranges = [e for e in prof.events() if e.name.startswith("anystereo/")][len(first):]
    assert [e.name for e in ranges] == [f"anystereo/{r['name']}" for r in records]
    for r, e in zip(records, ranges):
        assert abs(r["trace_us"][0] - e.time_range.start) < TRACE_TOL_US, r["name"]
        assert abs(r["trace_us"][1] - e.time_range.end) < TRACE_TOL_US, r["name"]
        assert r["anchor_us"] is None


def test_a_span_counts_the_hand_written_launches_in_it():
    assert list(profiling.launch_counts()) == [name for name, _, _ in profiling.KERNELS]
    with profiling.record_spans() as rec:
        with profiling.span("outer"):
            with profiling.span("inner"):
                gather_pyramid_aligned.launches += 2
    outer, inner = rec.collect()
    assert outer["launches"] == inner["launches"] == {"B1 fwd": 2}
    assert inner["parent"] == outer["id"] and inner["root"] == outer["root"] == outer["id"]


def _batch(seed):
    rng = np.random.RandomState(seed)
    left = (rng.rand(B, TRAIN_H, TRAIN_W, 3) * 255).astype(np.float32)
    batch = {"left": left, "right": np.roll(left, -3, axis=2),
             "coords": (rng.rand(B, TRAIN_Q, 2) * 2 - 1).astype(np.float32),
             "gt": np.full((B, TRAIN_Q), 3.0, np.float32), "valid": np.ones((B, TRAIN_Q), np.float32),
             "scale": np.ones(B, np.float32), "gt_low": np.full((B, TRAIN_H // 4, TRAIN_W // 4), 0.75, np.float32)}
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _train_step_tree(records, iters):
    steps = [r for r in records if r["name"] == "train_step"]
    assert steps and all(r["parent"] is None for r in steps)
    for step in steps:
        kids = _children(records, step)
        assert [r["name"] for r in kids] == ["forward", "loss", "backward", "optimizer"]
        stages = _children(records, kids[0])
        assert [r["name"] for r in stages] == ["matching", "cost", "context"] + ["gru"] * iters
        assert {r["root"] for r in kids + stages} == {step["id"]}
    return steps


@pytest.mark.parametrize("where", ["step", "step_remat", "train"])
def test_training_spans(where, tmp_path):
    iters = 2
    cfg = Config(model=dataclasses.replace(SMALL, remat=where == "step_remat"),
                 train=TrainConfig(train_iters=iters, batch_size=B, num_steps=2, ckpt_every=1000,
                                   ckpt_dir=str(tmp_path / "ck"), inp_size=(TRAIN_H, TRAIN_W)))
    if where == "train":
        root = str(tmp_path / "data")
        gen_sceneflow(root, np.random.RandomState(0), n_train=3, n_test=1, h=48, w=96)
        aug = AugmentorConfig(crop_size=cfg.train.inp_size, min_scale=-0.2, max_scale=0.4, yjitter=True)
        ds = fetch_dataset(["sceneflow"], {"sceneflow": root}, aug, multi_scale=True, inp_size=cfg.train.inp_size,
                           scale_min=cfg.train.scale_min, scale_max=cfg.train.scale_max)
        with profiling.record_spans() as rec:
            trainer.train(cfg, PrefetchLoader(ds, B, num_workers=1, seed=3), max_steps=2, device="cpu")
        records = rec.collect()
        assert len(_train_step_tree(records, iters)) == 2
        waits = [r for r in records if r["name"] == "loader_wait"]
        assert len(waits) == 2 and all(r["parent"] is None for r in waits)
        return
    state = create_train_state(build_model(cfg.model, "cpu"), cfg.train, "cpu")
    step = make_train_step(state.model, cfg.train, device="cpu")
    with profiling.record_spans() as rec:
        step(state, _batch(0))
    assert len(_train_step_tree(rec.collect(), iters)) == 1
