"""Data-parallel training of the PyTorch port (`parallel/mesh.py`, the
distributed path of `train/step.py` and `train/trainer.py`) on the CPU over
gloo.

Two ranks (subprocesses), each with one sample of a batch of two whose valid
masks differ (all 256 queries valid in one, 40 in the other), run
`train()` for two steps; one process runs the same two steps on the whole
batch.  The loss is a masked mean over the batch, so a step that averaged
the ranks' own means would be off by a large factor; the ranks instead sum
the valid counts before the forward and the gradients after the backward.
Both sides run the CPU's native convolutions (oneDNN off), which compute a
batch one sample at a time, so that a sample's forward sums in the same
order in a batch of one and of two; oneDNN picks other algorithms for
other batch sizes, and its order noise (1e-6 of the loss) comes out of the
convolutions that feed a normalisation magnified 10^4-fold in their weight
gradients (1.4% of one stem's), which Adam's first, sign-like steps then
carry into whole-step differences.  Tolerances: the loss and the metrics of
each step within 1e-6 relative, the gradient norm within 1e-4; the
parameters after two steps within 1e-5 of the model's norm, and each tensor
within 5% of its own update (a tensor left unreduced is off by about its
whole update; measured worst 1.6%, a zero-initialised bias whose Adam
moments nearly cancel at the second step).

The same two ranks also take one step from the JAX package's weights
(seeded flax variables carried over with `from_flax`) on the first batch,
and their loss, metrics and summed gradients are held to the JAX package's
own loss and gradients on the whole batch of two (one jit) at
`tests/test_torch_train.py`'s fp32 bands: the loss and the metrics within
1e-4 relative, the gradient norm within 1e-3, each gradient
||Δ|| <= 1e-3·||g|| + 1e-6.  So the valid-count semantics are checked
against the reference and not only against the port.

In the ranks' `train()` every rank calls the validation hook, and
`validate_dataset(split_over_ranks=True)` validates frame i on rank
i mod 2 and sums the per-image metrics over the ranks: each rank loads only
its share, and every rank returns the mean over all frames (held to one
process validating every frame with the same weights).

The model is the IGEV model at the golden shape (32x64, max_disp 32, three
GRU levels) with narrow GRUs, fp32, one iteration, 256 queries a sample.
"""

import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from anystereo_tpu_torch.config import Config, MeshConfig, ModelConfig, TrainConfig
from anystereo_tpu_torch.eval import validate as tval
from anystereo_tpu_torch.nn.model import build_model
from anystereo_tpu_torch.parallel import mesh
from anystereo_tpu_torch.train import state as ts
from anystereo_tpu_torch.train import trainer as tr
from anystereo_tpu_torch.train.step import make_train_step
from anystereo_tpu_torch.utils.weights import from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, Q, STEPS = 32, 64, 256, 2
MODEL = ModelConfig(max_disp=32, compute_dtype="float32", hidden_dims=(32, 32, 32), n_gru_layers=3)
VALID = (Q, 40)  # valid queries of sample 0 and of sample 1
LOSS_RTOL, GRAD_NORM_RTOL, PARAM_RTOL, UPDATE_RTOL = 1e-6, 1e-4, 1e-5, 5e-2
# the ranks against the JAX package (tests/test_torch_train.py's fp32 bands)
JAX_LOSS_RTOL, JAX_GRAD_NORM_RTOL, JAX_GRAD_RTOL, JAX_GRAD_ATOL = 1e-4, 1e-3, 1e-3, 1e-6
VAL_FRAMES = 3  # odd: the two ranks validate unequal shares


def _per_sample_arithmetic():
    """Two intra-op threads (a parallel test run shares the cores) and the
    native convolutions, which compute a batch one sample at a time, so a
    sample sums in the same order in a batch of one and of two."""
    torch.set_num_threads(2)
    torch.backends.mkldnn.enabled = False


@pytest.fixture(autouse=True, scope="module")
def _arithmetic():
    n, mkldnn = torch.get_num_threads(), torch.backends.mkldnn.enabled
    _per_sample_arithmetic()
    yield
    torch.set_num_threads(n)
    torch.backends.mkldnn.enabled = mkldnn


def _cfg(ckpt_dir, batch, data=1):
    return Config(model=MODEL, mesh=MeshConfig(data=data), train=TrainConfig(
        train_iters=1, batch_size=batch, num_steps=100, ckpt_every=1000, ckpt_dir=str(ckpt_dir),
        inp_size=(H, W)))


def state_seed():
    return TrainConfig().seed


def _batch(step):
    """The step's batch of two samples, seeded, with unequal valid masks."""
    rng = np.random.RandomState(100 + step)
    left = (rng.rand(2, H, W, 3) * 255).astype(np.float32)
    valid = np.zeros((2, Q), np.float32)
    for i, n in enumerate(VALID):
        valid[i, rng.permutation(Q)[:n]] = 1
    return {
        "left": left,
        "right": np.roll(left, -3, axis=2),
        "coords": (rng.rand(2, Q, 2) * 2 - 1).astype(np.float32),
        "gt": (2.0 + 4.0 * rng.rand(2, Q)).astype(np.float32),
        "valid": valid,
        "scale": np.ones(2, np.float32),
        "gt_low": np.full((2, H // 4, W // 4), 0.75, np.float32),
    }


class _Loader:
    """The seeded batches of every step, or one sample of each (`rows`)."""

    def __init__(self, rows=slice(None)):
        self.rows = rows

    def __iter__(self):
        for step in range(STEPS):
            yield {k: v[self.rows] for k, v in _batch(step).items()}


class _Frames:
    """VAL_FRAMES seeded frames in `validate_dataset`'s format, held in
    memory; `loaded` lists the frames read."""

    def __init__(self):
        rng = np.random.RandomState(9)
        self.frames = [((rng.rand(H, W, 3) * 255).astype(np.float32), (rng.rand(H, W, 3) * 255).astype(np.float32),
                        (2.0 + 4.0 * rng.rand(H, W)).astype(np.float32), (rng.rand(H, W) > 0.2).astype(np.float32))
                       for _ in range(VAL_FRAMES)]
        self.loaded = []

    def __len__(self):
        return len(self.frames)

    def _load_raw(self, i):
        self.loaded.append(i)
        left, right, disp, valid = self.frames[i]
        return left, right, np.stack([disp, np.zeros_like(disp)], axis=-1), valid


def _validate(model, frames, split):
    return tval.validate_dataset(model, frames, valid_iters=1, device="cpu", split_over_ranks=split)


def _run(cfg, loader, validate_fn=None):
    """train() for STEPS steps on the CPU; returns the state and each step's
    metrics (as floats)."""
    seen = []
    real = tr.make_train_step

    def recording(*a, **kw):
        step = real(*a, **kw)

        def wrapped(state, batch):
            state, metrics = step(state, batch)
            seen.append({k: float(v) for k, v in metrics.items()})
            return state, metrics

        return wrapped

    tr.make_train_step = recording
    try:
        state = tr.train(cfg, loader, validate_fn, max_steps=STEPS, device="cpu")
    finally:
        tr.make_train_step = real
    return state, seen


def _step_from_jax_weights(rank, out):
    """One step of `make_train_step` from the JAX package's weights
    (`out/jax_weights.pt`) on this rank's sample of the first batch; its
    metrics and the summed gradients before clipping.  With oneDNN: the
    native convolutions' 3-D weight gradients are an order of magnitude
    further from float64 here than oneDNN's or XLA's."""
    model = build_model(MODEL, "cpu")
    model.load_state_dict(torch.load(os.path.join(out, "jax_weights.pt"), weights_only=True), strict=True)
    tcfg = _cfg(out, batch=1).train
    state = ts.create_train_state(model, tcfg, device="cpu")
    batch = {k: torch.from_numpy(v[rank:rank + 1]) for k, v in _batch(0).items()}
    with torch.backends.mkldnn.flags(enabled=True):
        _, metrics = make_train_step(model, tcfg, device="cpu")(state, batch)
    scale = max(float(metrics["grad_norm"]) / tcfg.grad_clip, 1.0)  # undo the clip
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad * scale for n, p in model.named_parameters()}}


def rank_main(rank, world, port, out):
    """One rank of the two-rank run (its own process): the group over gloo;
    one step from the JAX package's weights; then `train()` on the rank's
    sample of every batch, with its own checkpoint directory (so that what
    rank 1 writes shows) and a validation hook; its results to `out`."""
    _per_sample_arithmetic()
    os.environ.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES=str(world),
                      PROCESS_ID=str(rank))
    assert mesh.maybe_initialize_distributed(require=True, device="cpu")
    try:
        from_jax = _step_from_jax_weights(rank, out)
        frames, validated = _Frames(), []
        cfg = _cfg(os.path.join(out, f"ck{rank}"), batch=1, data=0)
        state, seen = _run(cfg, _Loader(slice(rank, rank + 1)),
                           lambda state, step: validated.append(_validate(state.model, frames, True)))
        torch.save({"metrics": seen, "params": dict(state.model.named_parameters()), "from_jax": from_jax,
                    "validated": validated, "frames_loaded": frames.loaded},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_variables():
    """Seeded flax variables of the JAX model at MODEL's widths (jax is
    imported here, not at the top: the ranks import this module)."""
    import jax
    from anystereo_tpu.config import ModelConfig as JaxConfig
    from anystereo_tpu.nn.model import AnyStereo as JaxAnyStereo
    from test_torch_model import _seeded_variables

    b = _batch(0)
    jm = JaxAnyStereo(JaxConfig(max_disp=MODEL.max_disp, compute_dtype="float32", hidden_dims=MODEL.hidden_dims,
                                n_gru_layers=MODEL.n_gru_layers))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), b["left"][:1], b["right"][:1], iters=1,
                                            mode="eval"))
    return jm, _seeded_variables(shapes)


def _jax_full_batch(jm, variables):
    """The JAX package's loss, metrics and gradients on the whole first
    batch (both samples), one jit closed over the batch."""
    import jax
    import optax
    from anystereo_tpu.train import loss as jloss

    tcfg, b = _cfg("", batch=2).train, _batch(0)

    def loss_fn(params):
        out = jm.apply({"params": params}, b["left"], b["right"], iters=tcfg.train_iters, coords=b["coords"],
                       scale=b["scale"], mode="train")
        return jloss.sequence_loss_queries(out.disp_preds, b["gt"], b["valid"], max_disp=tcfg.max_disp_loss,
                                           gamma=tcfg.loss_gamma)

    def run(params):
        (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, metrics, grads, optax.global_norm(grads)

    assert not tcfg.supervise_init
    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(variables["params"]))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The ranks' results, and the JAX package's full-batch step (computed
    while the ranks run)."""
    out = str(tmp_path_factory.mktemp("dp"))
    jm, variables = _jax_variables()
    torch.save(from_flax(variables), os.path.join(out, "jax_weights.pt"))
    port = _free_port()
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import test_torch_parallel as t; "
            "t.rank_main(int(sys.argv[2]), 2, int(sys.argv[3]), sys.argv[4])")
    env = {**os.environ, "OMP_NUM_THREADS": "2", "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", code, os.path.join(REPO, "tests"), str(r), str(port), out],
                              env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    jax_step = _jax_full_batch(jm, variables)
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return SimpleNamespace(out=out, jax=jax_step, ranks=[
        torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=True) for r in range(2)])


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    return _run(_cfg(tmp_path_factory.mktemp("one") / "ck", batch=2), _Loader())


def test_two_ranks_take_the_full_batch_loss(two_ranks, one_process):
    _, want = one_process
    for r in two_ranks.ranks:
        assert len(r["metrics"]) == STEPS
        for got, ref in zip(r["metrics"], want):
            for k in ("loss", "epe", "1px", "3px"):
                assert got[k] == pytest.approx(ref[k], rel=LOSS_RTOL), (k, got[k], ref[k])
            assert got["grad_norm"] == pytest.approx(ref["grad_norm"], rel=GRAD_NORM_RTOL)
            assert got["lr"] == ref["lr"] and got["nonfinite_skips"] == 0
    # the masks are unequal enough that the mean of the ranks' own means is
    # another loss altogether
    b = _batch(0)
    share = [float(b["valid"][i].sum()) for i in range(2)]
    assert share[0] / sum(share) > 0.8


def test_two_ranks_take_the_full_batch_step(two_ranks, one_process):
    """Every parameter after two steps: the model within 1e-5 of its norm,
    and each tensor within 5% of its own update (a tensor the ranks did not
    reduce is off by about its whole update)."""
    ranks = two_ranks.ranks
    state, _ = one_process
    want = {k: p.detach() for k, p in state.model.named_parameters()}
    start = dict(build_model(MODEL, "cpu", seed=state_seed()).named_parameters())
    norm = torch.linalg.vector_norm
    for r in ranks:
        got = r["params"]
        assert sorted(got) == sorted(want)
        diff = norm(torch.stack([norm(got[k] - w) for k, w in want.items()]))
        assert diff <= PARAM_RTOL * norm(torch.stack([norm(w) for w in want.values()]))
        for k, w in want.items():
            assert norm(got[k] - w) <= UPDATE_RTOL * norm(w - start[k].detach()), k
    # and the ranks hold the same replica
    assert all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]) for k in want)


def test_two_ranks_take_the_jax_full_batch_gradient(two_ranks):
    """One step from the JAX package's weights, a sample a rank: the loss,
    the metrics and the summed gradients are the JAX package's on the whole
    batch (test_torch_train.py's fp32 bands)."""
    loss, metrics, grads, gnorm = two_ranks.jax
    want = from_flax({"params": grads})
    norm = torch.linalg.vector_norm
    for r in two_ranks.ranks:
        got = r["from_jax"]
        assert got["metrics"]["loss"] == pytest.approx(float(loss), rel=JAX_LOSS_RTOL)
        for k in ("epe", "1px", "3px"):
            np.testing.assert_allclose(got["metrics"][k], float(metrics[k]), rtol=JAX_LOSS_RTOL, atol=1e-6)
        assert got["metrics"]["grad_norm"] == pytest.approx(float(gnorm), rel=JAX_GRAD_NORM_RTOL)
        assert sorted(got["grads"]) == sorted(want)
        bad = [(n, float(norm(got["grads"][n] - w)), float(norm(w))) for n, w in want.items()
               if norm(got["grads"][n] - w) > JAX_GRAD_RTOL * norm(w) + JAX_GRAD_ATOL]
        assert not bad, bad
    a, b = (r["from_jax"]["grads"] for r in two_ranks.ranks)
    assert all(torch.equal(a[n], b[n]) for n in a)


def test_every_rank_validates_its_share(two_ranks):
    """Frame i on rank i mod 2 (no rank waits on another's whole
    validation), and every rank returns the mean over all frames: that of
    one process validating every frame with the same weights."""
    ranks = two_ranks.ranks
    assert [r["frames_loaded"] for r in ranks] == [[0, 2], [1]]
    model = build_model(MODEL, "cpu")
    model.load_state_dict(ranks[0]["params"], strict=False)
    frames = _Frames()
    want = _validate(model, frames, False)
    assert frames.loaded == list(range(VAL_FRAMES))
    for r in ranks:
        (got,) = r["validated"]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-12, abs=1e-12), k


def test_only_rank_zero_writes_the_checkpoint(two_ranks):
    out = two_ranks.out
    assert ts.checkpoint_steps(os.path.join(out, "ck0")) == [STEPS]
    assert not os.path.exists(os.path.join(out, "ck1")) or not os.listdir(os.path.join(out, "ck1"))


@pytest.mark.parametrize("data,spatial,world,want", [
    (0, 1, 4, (4, 1)), (2, 1, 2, (2, 1)), (1, 1, 1, (1, 1)),
    (0, 3, 8, ValueError), (4, 1, 2, ValueError), (3, 2, 8, ValueError),
    (0, 2, 8, NotImplementedError), (2, 1, 1, NotImplementedError),
])
def test_check_mesh(data, spatial, world, want):
    """The JAX package's mesh rules (`tests/test_parallel.py`): data 0 is
    the whole world, a product other than the world raises ValueError;
    spatial tiling, and several cards in one process, are not ported."""
    cfg = MeshConfig(data=data, spatial=spatial)
    if isinstance(want, tuple):
        assert mesh.check_mesh(cfg, world) == want
    else:
        with pytest.raises(want):
            mesh.check_mesh(cfg, world)


def test_initialize_from_the_environment(monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "RANK",
              "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.maybe_initialize_distributed(device="cpu") is False
    with pytest.raises(RuntimeError, match="no cluster environment"):
        mesh.maybe_initialize_distributed(require=True, device="cpu")
    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:1")
    with pytest.raises(RuntimeError, match="NUM_PROCESSES"):
        mesh.maybe_initialize_distributed(require=True, device="cpu")
    assert mesh.backend_for("cpu") == "gloo" and mesh.backend_for("cuda") == "nccl"
    # torchrun's contract, a world of one: initialised once, then a no-op
    monkeypatch.delenv("COORDINATOR_ADDRESS")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    try:
        assert mesh.maybe_initialize_distributed(require=True, device="cpu") is False
        assert torch.distributed.get_backend() == "gloo"
        assert mesh.maybe_initialize_distributed(require=True, device="cpu") is False
    finally:
        torch.distributed.destroy_process_group()
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh.rank_device("cpu") == torch.device("cpu")


def test_cli_multihost_needs_a_cluster(monkeypatch, tmp_path):
    from anystereo_tpu_torch import cli

    for k in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="no cluster environment"):
        cli.main(["train", "--data-root", str(tmp_path), "--multihost", "--device", "cpu"])
