"""The port's checkpointable loader through the port's `train()` (the JAX
package's `tests/test_train.py::TestGrainResume`, on the port alone): a run
preempted after 3 steps, its loader state saved beside the checkpoint and
resumed to step 5, serves the records of a straight 5-step run in the same
order, none repeated and none skipped, into the second epoch.

IGEV at `max_disp` 32 with narrow GRUs (one level of 32 channels), batch 1
of 64x128 crops in multi-scale mode, 2 GRU iterations, on the CPU; the
dataset is four 120x200 pairs written by the port's own PNG and PFM
writers.
"""

import glob

import numpy as np
import pytest
import torch

from anystereo_tpu_torch.config import Config, ModelConfig, TrainConfig
from anystereo_tpu_torch.data.augment import AugmentorConfig
from anystereo_tpu_torch.data.datasets import StereoDataset
from anystereo_tpu_torch.data.frame_utils import write_pfm
from anystereo_tpu_torch.data.grain_loader import GrainLoader
from anystereo_tpu_torch.data.png import write_png
from anystereo_tpu_torch.train.trainer import train


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: a parallel test run shares the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.RandomState(5)
    out = []
    for i in range(4):
        img = (rng.rand(120, 200, 3) * 255).astype(np.uint8)
        left, right, disp = str(root / f"l{i}.png"), str(root / f"r{i}.png"), str(root / f"d{i}.pfm")
        write_png(left, img)
        write_png(right, img)
        write_pfm(disp, np.tile(np.linspace(5, 40, 200, dtype=np.float32), (120, 1)))
        out.append((left, right, disp))
    return out


def _loader(files, served):
    ds = StereoDataset(aug=AugmentorConfig(crop_size=(64, 128), min_scale=-0.2, max_scale=0.4),
                       multi_scale=True, scale_min=1.0, scale_max=1.3, inp_size=(64, 128))
    for left, right, disp in files:
        ds.image_list.append([left, right])
        ds.disparity_list.append(disp)
    orig = ds.__getitem__

    def recording(i, rng=None):
        served.append(int(i))
        return orig(i, rng=rng)

    ds.__getitem__ = recording
    return GrainLoader(ds, 1, seed=11)


def _cfg(ckpt_dir, steps):
    return Config(model=ModelConfig(max_disp=32, hidden_dims=(32, 32, 32), n_gru_layers=1), train=TrainConfig(
        train_iters=2, batch_size=1, lr=1e-4, num_steps=steps, ckpt_every=1000, ckpt_dir=str(ckpt_dir),
        inp_size=(64, 128), scale_min=1.0, scale_max=1.3))


def test_exactly_once_data_order_across_resume(files, tmp_path):
    # straight run: 5 steps (into the second epoch of the 4 records)
    served_a = []
    train(_cfg(tmp_path / "a", 5), _loader(files, served_a), device="cpu")
    # preempted run: 3 steps, a checkpoint and its loader sidecar, then a resume to 5
    served_b1, served_b2 = [], []
    train(_cfg(tmp_path / "b", 3), _loader(files, served_b1), device="cpu")
    assert glob.glob(str(tmp_path / "b" / "loader_state-3-p0.bin"))
    state = train(_cfg(tmp_path / "b", 5), _loader(files, served_b2), device="cpu")
    assert state.step == 5
    # the prefetch runs one batch ahead: the straight run fetches batches
    # 0..5 for steps 0..4, the first part 0..3 for steps 0..2; the resumed
    # part fetches 0 and 1 before the restore, then the straight run's 3, 4
    # and 5 (batch 2 again, or a batch skipped, would show)
    assert len(served_a) == 6 and sorted(served_a[:4]) == [0, 1, 2, 3]
    assert served_b1 == served_a[:4]
    assert served_b2 == served_a[:2] + served_a[3:]
