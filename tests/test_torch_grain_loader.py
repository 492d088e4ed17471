"""The port's checkpointable input pipeline
(`anystereo_tpu_torch/data/grain_loader.py`) against the JAX package's
`GrainLoader` (grain's `IndexSampler` and `DataLoader`).

Over the synthetic SceneFlow tree (multi-scale, 32x64 crops, 12 samples an
epoch) the port's batches equal the JAX loader's into the second epoch at 0
and 2 workers and as hosts (0, 1), (0, 2) and (1, 2): integer arrays
exactly, images and disparities within the bands of
`test_torch_data.py::test_prefetch_loader_matches_jax`; so does the state
after every batch (grain's three fields).  A state taken from the port's
iterator or from the JAX loader's resumes a fresh iterator of the port
exactly where the straight run goes on, also after fetches made before the
restore (as the trainer makes them).  Hosts see disjoint records; a bad host
index and a state of another worker count raise; so does a sample that
raises.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
pytest.importorskip("grain")

from anystereo_tpu.data import augment as jaug  # noqa: E402
from anystereo_tpu.data import datasets as jds  # noqa: E402
from anystereo_tpu.data.grain_loader import GrainLoader as JaxGrainLoader  # noqa: E402
from anystereo_tpu_torch.data import augment as taug  # noqa: E402
from anystereo_tpu_torch.data import datasets as tds  # noqa: E402
from anystereo_tpu_torch.data.grain_loader import GrainLoader  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))
import make_synthetic_datasets as synth  # noqa: E402
from test_torch_data import _images_close  # noqa: E402

STATE_KEYS = ("last_seen_indices", "last_worker_index", "worker_count")
HOSTS = [(0, 1), (0, 2), (1, 2)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: a parallel test run shares the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    synth.gen_sceneflow(root, np.random.RandomState(0), n_train=3, n_test=3, h=96, w=160)
    return root


def _datasets(tree):
    """(JAX dataset, the port's): 3 training frames four times, 12 samples an epoch."""
    kw = dict(multi_scale=True, scale_min=1.0, scale_max=1.6, inp_size=(32, 64))
    jd = jds.SceneFlowDataset(tree, jaug.AugmentorConfig(yjitter=True), **kw)
    td = tds.SceneFlowDataset(tree, taug.AugmentorConfig(yjitter=True), **kw)
    return jd * 4, td * 4


def _assert_batches_close(got, want):
    assert set(got) == set(want)
    for k in want:
        if k in ("left", "right"):
            _images_close(got[k], want[k], k, exact=False)  # multi-scale: bicubic
        elif k in ("gt", "gt_low"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[k], want[k])


def _fields(state_bytes):
    state = json.loads(state_bytes)
    return {k: state[k] for k in STATE_KEYS}


@pytest.mark.parametrize("hosts", HOSTS)
@pytest.mark.parametrize("workers", [0, 2])
def test_batches_and_states_match_jax(tree, workers, hosts):
    jd, td = _datasets(tree)
    kw = dict(num_workers=workers, seed=7, host_index=hosts[0], host_count=hosts[1])
    want_loader, loader = JaxGrainLoader(jd, 2, **kw), GrainLoader(td, 2, **kw)
    assert len(loader) == len(want_loader) == 12 // hosts[1] // 2
    want_it, got_it = iter(want_loader), iter(loader)
    assert _fields(got_it.get_state()) == _fields(want_it.get_state())
    for _ in range(len(loader) + 1):  # into the second epoch
        _assert_batches_close(next(got_it), next(want_it))
        assert _fields(got_it.get_state()) == _fields(want_it.get_state())
    got_it.close()


@pytest.mark.parametrize("hosts", [(0, 1), (1, 2)])
@pytest.mark.parametrize("workers", [0, 2])
def test_state_round_trip_resumes_the_straight_run(tree, workers, hosts):
    _, td = _datasets(tree)
    kw = dict(num_workers=workers, seed=11, host_index=hosts[0], host_count=hosts[1])
    straight = iter(GrainLoader(td, 2, **kw))
    want = [next(straight) for _ in range(6)]
    straight.close()

    first = iter(GrainLoader(td, 2, **kw))
    for _ in range(3):
        next(first)
    state = first.get_state()
    first.close()

    resumed = iter(GrainLoader(td, 2, **kw))
    next(resumed), next(resumed)  # fetched before the restore, as the trainer does
    resumed.set_state(state)
    assert resumed.get_state() == state
    for w in want[3:]:
        got = next(resumed)
        assert set(got) == set(w) and all(np.array_equal(got[k], w[k]) for k in w)
    resumed.close()


@pytest.mark.parametrize("workers", [0, 2])
def test_resumes_from_the_jax_loaders_state(tree, workers):
    jd, td = _datasets(tree)
    want_it = iter(JaxGrainLoader(jd, 2, num_workers=workers, seed=3))
    for _ in range(4):
        next(want_it)
    got_it = iter(GrainLoader(td, 2, num_workers=workers, seed=3))
    got_it.set_state(want_it.get_state())
    for _ in range(3):
        _assert_batches_close(next(got_it), next(want_it))
    got_it.close()


def test_a_state_of_another_loader_raises(tree):
    _, td = _datasets(tree)
    it = iter(GrainLoader(td, 2, num_workers=2, seed=0))
    state = json.loads(it.get_state())
    with pytest.raises(ValueError, match="workers"):
        iter(GrainLoader(td, 2, num_workers=3, seed=0)).set_state(json.dumps(state))
    state["last_worker_index"] = 0  # no batch made yet, so no worker made the last one
    with pytest.raises(ValueError, match="not one of"):
        it.set_state(json.dumps(state))


class Recording:
    """A dataset that records the keys it serves."""

    def __init__(self, dataset):
        self.dataset, self.served = dataset, []

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i, rng=None):
        self.served.append(i)
        return self.dataset.__getitem__(i, rng=rng)


@pytest.mark.parametrize("shuffle", [False, True])
def test_hosts_partition_epoch(tree, shuffle):
    _, td = _datasets(tree)
    n = len(td)
    seen = []
    for hi in range(2):
        ds = Recording(td)
        it = iter(GrainLoader(ds, 1, seed=3, shuffle=shuffle, host_index=hi, host_count=2))
        for _ in range(n // 2):
            next(it)
        seen.append(set(ds.served))
    assert len(seen[0]) == len(seen[1]) == n // 2
    assert not (seen[0] & seen[1]), "hosts saw overlapping samples"
    assert seen[0] | seen[1] == set(range(n))


def test_bad_host_index_raises(tree):
    _, td = _datasets(tree)
    for hi in (2, -1):
        with pytest.raises(ValueError):
            GrainLoader(td, 2, host_index=hi, host_count=2)
    loader = GrainLoader(td, 2)  # no process group: host 0 of 1
    assert (loader.host_index, loader.host_count) == (0, 1)


class Broken:
    def __len__(self):
        return 4

    def __getitem__(self, i, rng=None):
        raise ValueError(f"cannot decode sample {i}")


@pytest.mark.parametrize("workers", [0, 2])
def test_raises_what_a_sample_raises(workers):
    it = iter(GrainLoader(Broken(), 2, num_workers=workers, seed=0))
    with pytest.raises(ValueError, match="cannot decode"):
        next(it)
    it.close()
