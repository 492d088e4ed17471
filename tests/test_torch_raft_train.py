"""One training step of the RAFT model (`raft_config()`, `corr_levels` 4) in
the PyTorch port vs the JAX package: train-mode forward with a query decode
after every iteration, sequence loss, backward, clip, AdamW.

Shape: 1x32x72 (rows of 18 at 1/4: odd tails at lookup levels 2 and 3),
`max_disp` 32, 2 GRU iterations, 256 scattered queries, scale 1.5, fp32.  The
JAX side assembles the loss as `anystereo_tpu/train/step.py` does, in one jit
of loss, gradients and updated parameters that closes over the batch.  (With
the batch passed as a jit argument, XLA's fp32 CPU program for this graph at
widths 72 and 80 returns context-encoder gradients 1.5e-2 away from the same
program in float64; with the batch as constants it agrees with float64 to
4e-6, and so does the port.  At width 64 both forms agree.)  `supervise_init` is
on: the RAFT core has no regressed initial disparity, and both packages skip
the init term rather than fail.  The port runs the step under both lookup
flavors; the "classify" one differentiates through the transposed volume that
the pyramid keeps.

Tolerances, as in `tests/test_torch_train.py`: `disp_preds` 1e-3 px; loss 1e-4
relative; each parameter's gradient ||Δ|| <= 1e-3·||g|| + 1e-6; after the
update |Δ| <= 2.1·lr everywhere and under 1% of the entries off by more than
1% of lr (the first AdamW update of an entry is close to -lr·sign(g)).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from anystereo_tpu.config import raft_config as jax_raft_config
from anystereo_tpu.nn.model import AnyStereo as JaxAnyStereo
from anystereo_tpu.train import loss as jloss
from anystereo_tpu.train import optimizer as jopt
from anystereo_tpu_torch.config import TrainConfig, raft_config
from anystereo_tpu_torch.nn.model import AnyStereo
from anystereo_tpu_torch.ops.kernels.lookup import gather_pyramid_aligned
from anystereo_tpu_torch.ops.kernels.lookup_window import gather_pyramid_window_pm
from anystereo_tpu_torch.train.state import create_train_state
from anystereo_tpu_torch.train.step import make_train_step
from anystereo_tpu_torch.utils.weights import from_flax

from test_torch_model import _seeded_variables

B, H, W, MAX_DISP, ITERS, Q = 1, 32, 72, 32, 2, 256
TCFG = TrainConfig(train_iters=ITERS, supervise_init=True, max_disp_loss=float(MAX_DISP))


def _batch():
    rng = np.random.RandomState(43)
    left = (rng.rand(B, H, W, 3) * 255).astype(np.float32)
    right = (rng.rand(B, H, W, 3) * 255).astype(np.float32)
    coords = (rng.rand(B, Q, 2) * 2 - 1).astype(np.float32)
    gt = (rng.rand(B, Q) * 20 + 2).astype(np.float32)
    gt[0, :5] = 50.0  # beyond max_disp_loss: masked
    valid = (rng.rand(B, Q) > 0.1).astype(np.float32)
    gt_low = (rng.rand(B, H // 4, W // 4) * 6).astype(np.float32)
    return dict(left=left, right=right, coords=coords, gt=gt, valid=valid,
                scale=np.asarray([1.5], np.float32), gt_low=gt_low)


@pytest.fixture(scope="module")
def variables():
    b = _batch()
    jm = JaxAnyStereo(jax_raft_config(max_disp=MAX_DISP, compute_dtype="float32"))
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), b["left"], b["right"], iters=1, mode="eval"))
    return _seeded_variables(shapes)


@pytest.fixture(scope="module")
def jax_step(variables):
    """loss, metrics, disp_preds, gradients, updated parameters, gradient norm."""
    jm = JaxAnyStereo(jax_raft_config(max_disp=MAX_DISP, compute_dtype="float32"))
    tx = jopt.make_optimizer(lr=TCFG.lr, weight_decay=TCFG.weight_decay, num_steps=TCFG.num_steps,
                             grad_clip=TCFG.grad_clip, pct_start=TCFG.warmup_frac)

    batch = {k: jnp.asarray(v) for k, v in _batch().items()}

    def run(params):
        def loss_fn(p):
            out = jm.apply({"params": p}, batch["left"], batch["right"], iters=ITERS,
                           coords=batch["coords"], scale=batch["scale"], mode="train")
            loss, metrics = jloss.sequence_loss_queries(
                out.disp_preds, batch["gt"], batch["valid"], max_disp=TCFG.max_disp_loss,
                gamma=TCFG.loss_gamma)
            if TCFG.supervise_init and out.init_disp is not None:
                loss = loss + jloss.init_disp_loss(out.init_disp, batch["gt_low"], TCFG.max_disp_loss)
            return loss, (metrics, out.disp_preds)

        (loss, (metrics, preds)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return loss, metrics, preds, grads, optax.apply_updates(params, updates), optax.global_norm(grads)

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(variables["params"]))


_TORCH = {}


def _torch_step(variables, kernel, monkeypatch):
    """The port's forward and one step under a lookup flavor, computed once."""
    monkeypatch.setenv("ANYSTEREO_LOOKUP_KERNEL", kernel)
    if kernel in _TORCH:
        return _TORCH[kernel]
    tm = AnyStereo(raft_config(max_disp=MAX_DISP, compute_dtype="float32"))
    tm.load_state_dict(from_flax(variables), strict=True)
    state = create_train_state(tm, TCFG, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    before = (gather_pyramid_aligned.launches, gather_pyramid_window_pm.launches)
    out = tm(batch["left"], batch["right"], iters=ITERS, coords=batch["coords"],
             scale=batch["scale"], mode="train")
    state, metrics = make_train_step(tm, TCFG, device="cpu")(state, batch)
    assert (gather_pyramid_aligned.launches, gather_pyramid_window_pm.launches) == before
    scale = max(metrics["grad_norm"] / TCFG.grad_clip, 1.0)  # undo the in-place clip
    _TORCH[kernel] = dict(
        state=state, metrics=metrics, out=out,
        grads={n: p.grad * scale for n, p in tm.named_parameters()},
        params={n: p.detach().clone() for n, p in tm.named_parameters()})
    return _TORCH[kernel]


KERNELS = ["aligned", "classify"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_raft_train_forward_fp32(variables, jax_step, kernel, monkeypatch):
    out = _torch_step(variables, kernel, monkeypatch)["out"]
    assert out.init_disp is None
    assert out.disp_preds.shape == (ITERS, B, Q) and out.disp_preds.requires_grad
    assert torch.equal(out.disp_final, out.disp_preds[-1])
    np.testing.assert_allclose(out.disp_preds.detach().numpy(), jax_step[2], rtol=0, atol=1e-3)


@pytest.mark.parametrize("kernel", KERNELS)
def test_raft_loss_skips_the_init_term(variables, jax_step, kernel, monkeypatch):
    """`supervise_init=True` without a regressed initial disparity: the init
    term is skipped on both sides, and the losses agree."""
    got = _torch_step(variables, kernel, monkeypatch)
    loss, metrics, _, _, _, gnorm = jax_step
    m = got["metrics"]
    np.testing.assert_allclose(float(m["loss"]), float(loss), rtol=1e-4)
    np.testing.assert_allclose(m["grad_norm"], float(gnorm), rtol=1e-3)
    for k in ("epe", "1px", "3px"):
        np.testing.assert_allclose(float(m[k]), float(metrics[k]), rtol=1e-4, atol=1e-6)
    assert m["nonfinite_skips"] == 0 and got["state"].step == 1 and got["state"].total_notfinite == 0


@pytest.mark.parametrize("kernel", KERNELS)
def test_raft_every_gradient_fp32(variables, jax_step, kernel, monkeypatch):
    got = _torch_step(variables, kernel, monkeypatch)
    want = from_flax({"params": jax_step[3]})
    assert set(want) == set(got["grads"])
    bad, zero_t, zero_j = [], [], []
    for name, w in want.items():
        g = got["grads"][name]
        if float((g - w).norm()) > 1e-3 * float(w.norm()) + 1e-6:
            bad.append((name, float((g - w).norm()), float(w.norm())))
        if not g.any():
            zero_t.append(name)
        if not w.any():
            zero_j.append(name)
    assert not bad, bad
    assert zero_t == zero_j == []  # the RAFT core has no parameter cut off from the loss


@pytest.mark.parametrize("kernel", KERNELS)
def test_raft_parameters_after_one_step_fp32(variables, jax_step, kernel, monkeypatch):
    got = _torch_step(variables, kernel, monkeypatch)
    want, old = from_flax({"params": jax_step[4]}), from_flax(variables)
    grads = from_flax({"params": jax_step[3]})
    lr = TCFG.lr / 25  # the schedule's value at update 0
    n = off = 0
    for name, w in want.items():
        d_got, d_want = got["params"][name] - old[name], w - old[name]
        assert float((d_got - d_want).abs().max()) <= 2.1 * lr, name
        # a conv bias in front of an instance norm (every bias of the matching
        # encoder but its head's) has a zero gradient up to rounding noise
        noise = name.startswith("fnet.") and name.endswith(".bias") and name != "fnet.Conv_1.bias"
        assert (float(grads[name].norm()) < 1e-5) == noise, name
        if noise:
            continue
        assert float(d_want.abs().max()) > 0.5 * lr, name  # the step moved it
        off += int(((d_got - d_want).abs() > 0.01 * lr).sum())
        n += w.numel()
    assert off / n < 0.01, (off, n)
