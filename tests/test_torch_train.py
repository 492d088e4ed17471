"""The training slice of the PyTorch port vs the JAX package: the losses,
the learning-rate schedules, the optimizer with its skip of non-finite
updates, and the whole training step of the IGEV model (train-mode forward
with a query decode after every iteration, sequence loss with
init-disparity supervision, backward, clip, AdamW).

The whole-model cases run at the golden shape of `tests/test_golden.py`
(1x32x64, `max_disp` 32) with 2 GRU iterations, 256 scattered queries and
scale 1.5.  The JAX side is one jit of loss, gradients and updated
parameters per dtype, computed once in a module-scoped fixture; the flax
variables are seeded with numpy over `jax.eval_shape(init)` and carried over
with `from_flax`, which carries the JAX gradient tree across too.

Tolerances.  fp32: `disp_preds` 1e-3 px; loss 1e-4 relative; each
parameter's gradient ||Δ|| <= 1e-3·||g|| + 1e-6 (conv and matmul sums in
another order, measured ~1e-5 relative).  The first AdamW update of an entry
is -lr·g/(|g| + 1e-8), close to -lr·sign(g): entries whose gradient is below
the two frameworks' rounding noise can differ by up to 2·lr, so the updated
parameters are held by the share of entries that moved differently by more
than 1% of lr (under 1%), and by |Δ| <= 2.1·lr everywhere.  bf16: the
forward and the loss are held to the JAX package's bf16 forward (one cheap
jit; both sides round at the same points): measured `disp_preds` 0.16 px
max / 0.04 px mean apart and the loss 5e-4 relative; the band is 0.5 px
max, 0.1 px mean, 1e-2 relative.  The bf16 gradients are held to the port's
own fp32 gradients (which the fp32 case ties to `jax.grad`): measured
cosine 0.991 over the whole tree with norms 1% apart; the band is cosine
>= 0.95 and norms within 10%.  A second jit of the bf16 gradient would
cost 100 s of compile for the same statement.  remat: the recomputed
forward is the same arithmetic; only the order in which the iterations'
gradients are summed changes, ||Δ|| <= 1e-4·||g|| + 1e-7.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from anystereo_tpu.config import ModelConfig as JaxConfig
from anystereo_tpu.nn.model import AnyStereo as JaxAnyStereo
from anystereo_tpu.train import loss as jloss
from anystereo_tpu.train import optimizer as jopt
from anystereo_tpu_torch.config import ModelConfig, TrainConfig
from anystereo_tpu_torch.nn.model import AnyStereo
from anystereo_tpu_torch.train import loss as tloss
from anystereo_tpu_torch.train import optimizer as topt
from anystereo_tpu_torch.train.state import TrainState, create_train_state
from anystereo_tpu_torch.train.step import loss_and_metrics, make_train_step
from anystereo_tpu_torch.utils.weights import from_flax

from test_torch_model import _seeded_variables

# ------------------------------------------------------------------ losses


def _loss_inputs(rng, it=3, b=2, q=50):
    preds = rng.randn(it, b, q).astype(np.float32) * 3 + 5
    gt = (rng.rand(b, q) * 10).astype(np.float32)
    gt[0, :3] = 900.0  # beyond max_disp: masked
    valid = (rng.rand(b, q) > 0.3).astype(np.float32)
    return preds, gt, valid


@pytest.mark.parametrize("n,gamma", [(1, 0.9), (2, 0.9), (16, 0.9), (22, 0.8)])
def test_iter_weights(n, gamma):
    np.testing.assert_allclose(tloss._iter_weights(n, gamma).numpy(),
                               np.asarray(jloss._iter_weights(n, gamma)), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sequence_loss_queries(rng, dtype):
    preds, gt, valid = _loss_inputs(rng)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    (want, wm), wgrad = jax.value_and_grad(
        lambda p: jloss.sequence_loss_queries(p.astype(jdt), jnp.asarray(gt), jnp.asarray(valid)),
        has_aux=True)(jnp.asarray(preds))
    p = torch.from_numpy(preds).requires_grad_(True)
    got, gm = tloss.sequence_loss_queries(p.to(tdt), torch.from_numpy(gt), torch.from_numpy(valid))
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for k in ("epe", "1px", "3px"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(wgrad), rtol=1e-5, atol=1e-8)


def test_sequence_loss_all_masked_is_zero(rng):
    preds, gt, _ = _loss_inputs(rng)
    loss, m = tloss.sequence_loss_queries(torch.from_numpy(preds), torch.from_numpy(gt),
                                          torch.zeros(gt.shape))
    assert float(loss) == 0.0 and float(m["epe"]) == 0.0


def test_sequence_loss_dense(rng):
    preds = rng.randn(2, 1, 4, 6).astype(np.float32)
    gt, valid = rng.rand(1, 4, 6).astype(np.float32), np.ones((1, 4, 6), np.float32)
    want, _ = jloss.sequence_loss(jnp.asarray(preds), jnp.asarray(gt), jnp.asarray(valid), 700.0, 0.8)
    got, _ = tloss.sequence_loss(torch.from_numpy(preds), torch.from_numpy(gt),
                                 torch.from_numpy(valid), 700.0, 0.8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_init_disp_loss_and_smooth_l1(rng):
    init = (rng.randn(2, 8, 16) * 2 + 3).astype(np.float32)
    gt_low = (rng.rand(2, 8, 16) * 12).astype(np.float32)  # some beyond 32/4
    want = jloss.init_disp_loss(jnp.asarray(init), jnp.asarray(gt_low), 32.0)
    got = tloss.init_disp_loss(torch.from_numpy(init), torch.from_numpy(gt_low), 32.0)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        tloss.smooth_l1(torch.from_numpy(init), torch.from_numpy(gt_low), 0.5).numpy(),
        np.asarray(jloss.smooth_l1(jnp.asarray(init), jnp.asarray(gt_low), 0.5)), rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------- schedules


@pytest.mark.parametrize("num_steps,pct", [(100_000, 0.01), (1000, 0.01), (20, 0.01), (500, 0.3)])
def test_one_cycle_schedule(num_steps, pct):
    want, got = jopt.one_cycle_schedule(2e-4, num_steps, pct), topt.one_cycle_schedule(2e-4, num_steps, pct)
    total = num_steps + 100
    warm = max(int(total * pct), 1)
    for s in (0, warm - 1, warm, (warm + total) // 2, total - 1, total, total + 50):
        # optax evaluates 1 - count/steps in fp32: 6e-8 of max_lr absolute
        np.testing.assert_allclose(got(s), float(want(s)), rtol=2e-5, atol=2e-4 * 1e-6,
                                   err_msg=str(s))
    np.testing.assert_allclose(got(0), 2e-4 / 25, rtol=1e-12)
    np.testing.assert_allclose(got(warm), 2e-4, rtol=1e-12)
    np.testing.assert_allclose(got(total), 2e-4 / 1e4, rtol=1e-9)


def test_step_decay_schedule():
    want, got = jopt.step_decay_schedule(1e-3, (10, 20, 35)), topt.step_decay_schedule(1e-3, (10, 20, 35))
    for s in (0, 9, 10, 11, 20, 34, 35, 100):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6, err_msg=str(s))


# --------------------------------------------------------------- optimizer

_TOY = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}


def _toy_grads(rng, step):
    g = {k: (rng.randn(*s) * (30.0 if step == 1 else 0.01)).astype(np.float32)
         for k, s in _TOY.items()}  # step 1 is clipped (norm >> 1), the others are not
    if step == 2:
        g["b"][1] = np.nan if rng.rand() < 2 else 0.0
    return g


@pytest.mark.parametrize("skip_nonfinite", [True, False])
def test_optimizer_five_steps_one_nonfinite(rng, skip_nonfinite):
    """Parameters, Adam's moments and count, and both skip counters after
    each of five updates with the same gradients; the third is non-finite.
    Without the skip both sides take the NaN step (compared up to it)."""
    kw = dict(lr=3e-3, weight_decay=1e-2, num_steps=50, grad_clip=1.0, pct_start=0.1)
    tx = jopt.make_optimizer(skip_nonfinite=skip_nonfinite, **kw)
    jp = {k: jnp.asarray(rng.randn(*s).astype(np.float32)) for k, s in _TOY.items()}
    tp = {k: torch.nn.Parameter(torch.from_numpy(np.asarray(v).copy())) for k, v in jp.items()}
    opt = topt.make_optimizer(tp.values(), skip_nonfinite=skip_nonfinite, **kw)
    js = tx.init(jp)
    for step in range(5 if skip_nonfinite else 2):
        grads = _toy_grads(rng, step)
        upd, js = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k].copy())
        info = opt.step()
        adam = (js.inner_state if skip_nonfinite else js)[1][0]
        assert opt.count == int(adam.count)
        assert info["applied"] == (step != 2)
        if skip_nonfinite:
            assert opt.notfinite_count == int(js.notfinite_count) == (1 if step == 2 else 0)
            assert opt.total_notfinite == int(js.total_notfinite) == (1 if step >= 2 else 0)
        for i, k in enumerate(_TOY):
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(opt.mu[i].numpy(), np.asarray(adam.mu[k]), rtol=1e-5, atol=1e-9)
            np.testing.assert_allclose(opt.nu[i].numpy(), np.asarray(adam.nu[k]), rtol=1e-5, atol=1e-12)


def test_clip_is_the_exact_rule():
    """Norm 5 against a bound of 1: g / 5 exactly, not g / (5 + 1e-6); a
    norm below the bound leaves g untouched."""
    p = torch.nn.Parameter(torch.zeros(2))
    opt = topt.Optimizer([p], lambda c: 0.0, grad_clip=1.0)
    p.grad = torch.tensor([3.0, 4.0])
    assert opt.step()["grad_norm"] == 5.0
    assert torch.equal(p.grad, torch.tensor([3.0, 4.0]) / 5.0 * 1.0)
    p.grad = torch.tensor([0.3, 0.4])
    opt.step()
    assert torch.equal(p.grad, torch.tensor([0.3, 0.4]))


def test_missing_grad_counts_as_zero():
    p, q = torch.nn.Parameter(torch.ones(2)), torch.nn.Parameter(torch.ones(2))
    opt = topt.Optimizer([p, q], lambda c: 0.1, weight_decay=0.5)
    p.grad = torch.tensor([1.0, -1.0])
    opt.step()
    torch.testing.assert_close(q.detach(), torch.full((2,), 1.0 - 0.1 * 0.5))  # decay only


# ----------------------------------------------------- the whole train step

B, H, W, MAX_DISP, ITERS, Q = 1, 32, 64, 32, 2, 256
TCFG = TrainConfig(train_iters=ITERS, supervise_init=True, max_disp_loss=float(MAX_DISP))


def _batch():
    rng = np.random.RandomState(42)
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
    jm = JaxAnyStereo(JaxConfig(max_disp=MAX_DISP, compute_dtype="float32"))
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), b["left"], b["right"], iters=1, mode="eval"))
    return _seeded_variables(shapes)


def _jax_step(variables, dtype):
    """loss, metrics, disp_preds, gradients and the parameters after one
    update, from the JAX package's model, losses and optimizer, one jit."""
    jm = JaxAnyStereo(JaxConfig(max_disp=MAX_DISP, compute_dtype=dtype))
    tx = jopt.make_optimizer(lr=TCFG.lr, weight_decay=TCFG.weight_decay, num_steps=TCFG.num_steps,
                             grad_clip=TCFG.grad_clip, pct_start=TCFG.warmup_frac)

    def run(params, batch):
        def loss_fn(p):
            out = jm.apply({"params": p}, batch["left"], batch["right"], iters=ITERS,
                           coords=batch["coords"], scale=batch["scale"], mode="train")
            loss, metrics = jloss.sequence_loss_queries(
                out.disp_preds, batch["gt"], batch["valid"], max_disp=TCFG.max_disp_loss,
                gamma=TCFG.loss_gamma)
            loss = loss + jloss.init_disp_loss(out.init_disp, batch["gt_low"], TCFG.max_disp_loss)
            return loss, (metrics, out.disp_preds)

        (loss, (metrics, preds)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return loss, metrics, preds, grads, optax.apply_updates(params, updates), optax.global_norm(grads)

    out = jax.jit(run)(variables["params"], {k: jnp.asarray(v) for k, v in _batch().items()})
    return jax.tree_util.tree_map(np.asarray, out)


def _torch_model(variables, dtype, remat=False):
    tm = AnyStereo(ModelConfig(max_disp=MAX_DISP, compute_dtype=dtype, remat=remat))
    tm.load_state_dict(from_flax(variables), strict=True)
    return tm


def _torch_step(variables, dtype):
    tm = _torch_model(variables, dtype)
    state = create_train_state(tm, TCFG, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with torch.no_grad():
        preds = tm(batch["left"], batch["right"], iters=ITERS, coords=batch["coords"],
                   scale=batch["scale"], mode="eval")
    assert preds.disp_preds is None and preds.disp_final.shape == (B, Q)
    out = tm(batch["left"], batch["right"], iters=ITERS, coords=batch["coords"],
             scale=batch["scale"], mode="train")
    state, metrics = make_train_step(tm, TCFG, device="cpu")(state, batch)
    # the step clips the gradients in place: undo it for the comparison
    scale = max(metrics["grad_norm"] / TCFG.grad_clip, 1.0)
    grads = {n: p.grad * scale for n, p in tm.named_parameters()}
    return dict(state=state, metrics=metrics, out=out, eval_final=preds.disp_final, grads=grads,
                params={n: p.detach().clone() for n, p in tm.named_parameters()})


@pytest.fixture(scope="module")
def fp32_pair(variables):
    return _torch_step(variables, "float32"), _jax_step(variables, "float32")


def test_train_forward_fp32(fp32_pair):
    got, (_, _, preds, _, _, _) = fp32_pair
    out = got["out"]
    assert out.disp_preds.shape == (ITERS, B, Q) and out.disp_preds.requires_grad
    assert torch.equal(out.disp_final, out.disp_preds[-1])
    np.testing.assert_allclose(out.disp_preds.detach().numpy(), preds, rtol=0, atol=1e-3)
    # eval mode at the same queries: the last iterate, no graph
    assert not got["eval_final"].requires_grad
    np.testing.assert_allclose(got["eval_final"].numpy(), preds[-1], rtol=0, atol=1e-3)


def test_train_loss_and_metrics_fp32(fp32_pair):
    got, (loss, metrics, _, _, _, gnorm) = fp32_pair
    m = got["metrics"]
    np.testing.assert_allclose(float(m["loss"]), float(loss), rtol=1e-4)
    np.testing.assert_allclose(m["grad_norm"], float(gnorm), rtol=1e-3)
    for k in ("epe", "1px", "3px"):
        np.testing.assert_allclose(float(m[k]), float(metrics[k]), rtol=1e-4, atol=1e-6)
    assert m["nonfinite_skips"] == 0 and got["state"].step == 1 and got["state"].total_notfinite == 0
    assert m["lr"] == pytest.approx(TCFG.lr / 25)


def test_every_gradient_fp32(fp32_pair):
    got, (_, _, _, grads, _, _) = fp32_pair
    want = from_flax({"params": grads})
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
    assert zero_t == zero_j == []  # with init supervision every parameter is reached


def test_parameters_after_one_step_fp32(fp32_pair, variables):
    got, (_, _, _, _, new_params, _) = fp32_pair
    want, old = from_flax({"params": new_params}), from_flax(variables)
    lr = TCFG.lr / 25  # the schedule's value at update 0
    n = off = 0
    for name, w in want.items():
        d_got, d_want = got["params"][name] - old[name], w - old[name]
        assert float((d_got - d_want).abs().max()) <= 2.1 * lr, name
        assert float(d_want.abs().max()) > 0.5 * lr, name  # the step moved it
        off += int(((d_got - d_want).abs() > 0.01 * lr).sum())
        n += w.numel()
    assert off / n < 0.01, (off, n)


def test_zero_gradients_without_init_supervision(variables):
    """At the default `supervise_init=False` only the classifier is cut off
    (it feeds the detached initial disparity alone), as in the JAX tree."""
    tm = _torch_model(variables, "float32")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    loss, _ = loss_and_metrics(tm, TrainConfig(train_iters=1, max_disp_loss=float(MAX_DISP)), batch)
    loss.backward()
    zero = [n for n, p in tm.named_parameters() if p.grad is None or not p.grad.any()]
    assert zero == ["classifier.weight"]


def test_remat_gives_the_same_gradients(variables):
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    grads = []
    for remat in (False, True):
        tm = _torch_model(variables, "float32", remat=remat)
        loss, _ = loss_and_metrics(tm, TCFG, batch)
        loss.backward()
        grads.append((float(loss.detach()), {n: p.grad for n, p in tm.named_parameters()}))
    assert grads[0][0] == pytest.approx(grads[1][0], rel=1e-6)
    for name, g in grads[0][1].items():
        assert float((grads[1][1][name] - g).norm()) <= 1e-4 * float(g.norm()) + 1e-7, name


def test_train_step_bf16_band(variables, fp32_pair):
    jm = JaxAnyStereo(JaxConfig(max_disp=MAX_DISP, compute_dtype="bfloat16"))

    def forward(params, batch):
        out = jm.apply({"params": params}, batch["left"], batch["right"], iters=ITERS,
                       coords=batch["coords"], scale=batch["scale"], mode="train")
        loss, _ = jloss.sequence_loss_queries(out.disp_preds, batch["gt"], batch["valid"],
                                              max_disp=TCFG.max_disp_loss, gamma=TCFG.loss_gamma)
        return loss + jloss.init_disp_loss(out.init_disp, batch["gt_low"], TCFG.max_disp_loss), \
            out.disp_preds

    loss, preds = jax.jit(forward)(variables["params"], {k: jnp.asarray(v) for k, v in _batch().items()})
    got = _torch_step(variables, "bfloat16")
    assert got["out"].disp_preds.dtype == torch.float32
    diff = np.abs(got["out"].disp_preds.detach().numpy() - np.asarray(preds))
    assert diff.max() <= 0.5 and diff.mean() <= 0.1, (diff.max(), diff.mean())
    np.testing.assert_allclose(float(got["metrics"]["loss"]), float(loss), rtol=1e-2)
    fp32 = fp32_pair[0]["grads"]
    assert all(g.dtype == torch.float32 for g in got["grads"].values())
    a = torch.cat([got["grads"][n].flatten() for n in fp32])
    b = torch.cat([g.flatten() for g in fp32.values()])
    assert float(torch.dot(a, b) / (a.norm() * b.norm())) >= 0.95
    assert 0.9 <= float(a.norm() / b.norm()) <= 1.1


def test_train_mode_rejects_dense_grid_and_bad_mode(variables):
    from anystereo_tpu_torch.ops.coords import _axis_centers

    tm = _torch_model(variables, "float32")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with pytest.raises(ValueError):
        tm(batch["left"], batch["right"], iters=1, mode="train",
           dense_grid=(_axis_centers(H), _axis_centers(W)))
    with pytest.raises(ValueError):
        tm(batch["left"], batch["right"], iters=1, mode="test")
    out = tm(batch["left"], batch["right"], iters=1, mode="train")  # default: every pixel centre
    assert out.disp_preds.shape == (1, B, H * W)


def test_entry_points_never_fall_back_to_cpu(variables, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = _torch_model(variables, "float32")
    with pytest.raises(RuntimeError):
        create_train_state(tm, TCFG)
    with pytest.raises(RuntimeError):
        make_train_step(tm, TCFG)
    assert isinstance(create_train_state(tm, TCFG, device="cpu"), TrainState)


def test_train_step_width_96_against_float64():
    """The step at 1x32x96 (rows of 24 at 1/4): loss and every gradient of
    the port in fp32 against the JAX package in float64."""
    w = 96
    rng = np.random.RandomState(42)
    b = dict(left=(rng.rand(B, H, w, 3) * 255).astype(np.float32),
             right=(rng.rand(B, H, w, 3) * 255).astype(np.float32),
             coords=(rng.rand(B, Q, 2) * 2 - 1).astype(np.float32),
             gt=(rng.rand(B, Q) * 20 + 2).astype(np.float32),
             valid=(rng.rand(B, Q) > 0.1).astype(np.float32),
             scale=np.asarray([1.5], np.float32),
             gt_low=(rng.rand(B, H // 4, w // 4) * 6).astype(np.float32))
    jm32 = JaxAnyStereo(JaxConfig(max_disp=MAX_DISP, compute_dtype="float32"))
    variables = _seeded_variables(jax.eval_shape(
        lambda: jm32.init(jax.random.PRNGKey(0), b["left"], b["right"], iters=1, mode="eval")))
    with jax.enable_x64(True):
        jm = JaxAnyStereo(JaxConfig(max_disp=MAX_DISP, compute_dtype="float64"))
        jb = {k: jnp.asarray(v, jnp.float64) for k, v in b.items()}

        def loss_fn(p):
            out = jm.apply({"params": p}, jb["left"], jb["right"], iters=ITERS, coords=jb["coords"],
                           scale=jb["scale"], mode="train")
            loss, _ = jloss.sequence_loss_queries(out.disp_preds, jb["gt"], jb["valid"],
                                                  max_disp=TCFG.max_disp_loss, gamma=TCFG.loss_gamma)
            return loss + jloss.init_disp_loss(out.init_disp, jb["gt_low"], TCFG.max_disp_loss)

        params64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), variables["params"])
        want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params64)
        assert jax.tree_util.tree_leaves(want)[0].dtype == jnp.float64
        want_loss, want = float(want_loss), jax.tree_util.tree_map(np.asarray, want)
    tm = _torch_model(variables, "float32")
    loss, _ = loss_and_metrics(tm, TCFG, {k: torch.from_numpy(v) for k, v in b.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-4)
    want = from_flax({"params": want})
    bad = [(n, float((p.grad - want[n]).norm()), float(want[n].norm()))
           for n, p in tm.named_parameters()
           if float((p.grad - want[n]).norm()) > 1e-3 * float(want[n].norm()) + 1e-6]
    assert not bad, bad


def test_trainer_step_and_checkpoint_match_jax(fp32_pair, variables, tmp_path, monkeypatch):
    """The training slice as a whole: the port's `train()` (prefetch to the
    device, the step, the checkpoint) from the same weights on the same batch
    takes the JAX step of the fp32 fixture, held to the bands of
    `test_parameters_after_one_step_fp32`; the checkpoint it writes restores
    bit for bit.  (The JAX package's own `train()` compiles its step for
    120-380 s on an 8-core CPU, so its step function stands in for it.)"""
    import dataclasses

    from anystereo_tpu_torch.config import Config
    from anystereo_tpu_torch.train import trainer
    from anystereo_tpu_torch.train.state import restore_checkpoint

    _, (loss, _, _, _, new_params, _) = fp32_pair
    seen = []
    monkeypatch.setattr(trainer.MetricLogger, "push", lambda self, step, m: seen.append(m))
    tcfg = dataclasses.replace(TCFG, ckpt_dir=str(tmp_path), ckpt_every=1)
    cfg = Config(model=ModelConfig(max_disp=MAX_DISP, compute_dtype="float32"), train=tcfg)
    state = create_train_state(_torch_model(variables, "float32"), tcfg, device="cpu")
    state = trainer.train(cfg, [_batch()], state=state, max_steps=1)
    assert state.step == 1 and len(seen) == 1
    np.testing.assert_allclose(float(seen[0]["loss"]), float(loss), rtol=1e-4)
    want, old = from_flax({"params": new_params}), from_flax(variables)
    lr = TCFG.lr / 25
    restored = create_train_state(_torch_model(variables, "float32"), tcfg, device="cpu")
    restore_checkpoint(str(tmp_path), restored)
    got = dict(state.model.named_parameters())
    n = off = 0
    for name, p in restored.model.named_parameters():
        assert torch.equal(p, got[name]), name
        d_got, d_want = p.detach() - old[name], want[name] - old[name]
        assert float((d_got - d_want).abs().max()) <= 2.1 * lr, name
        off += int(((d_got - d_want).abs() > 0.01 * lr).sum())
        n += p.numel()
    assert off / n < 0.01, (off, n)
    assert restored.optimizer.count == 1 and restored.step == 1
