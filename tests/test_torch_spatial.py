"""H-tiled spatial inference of the PyTorch port (`parallel/spatial.py`, the
spatial axis of `parallel/mesh.py`, `make_eval_step(mesh=...)`) on the CPU
over gloo.

Four ranks (subprocesses, one intra-op thread each) take the data x spatial
mesh 2 x 2 (`make_mesh`: spatial groups {0, 1} and {2, 3}) and run, while
this process computes the references (the JAX package's among them):

  (a) `halo_exchange` over all four ranks, halos 1 and 2, against the JAX
      package's `halo_exchange` under `shard_map` on 4 virtual devices:
      equal;
  (b) every op that couples rows, tiled over a pair of ranks (ranks 0-1 a
      64-row frame as 32 + 32, ranks 2-3 a 96-row one as 64 + 32), against
      the op on the whole frame: within 1e-6 (most are exact);
  (c, d) `infer_spatial_sharded` of the IGEV model (ranks 0-1) and of the
      RAFT model (ranks 2-3) on a 96x64 pair (64 + 32 rows), max_disp 32,
      fp32, 2 iterations, dense and at 300 seeded scattered queries, with
      the JAX package's weights (`from_flax`): against the port's unsharded
      forward within 3e-5 px, and against the JAX package's `model.apply`
      within 1e-4 px; the IGEV queries also against the JAX package's own
      `infer_spatial_sharded` on 2 virtual devices (a 9 s compile here);
  (e) `make_eval_step(mesh=...)` on meshes 2 x 2, 4 x 1 and 1 x 4 (a batch
      of 4 at 128x64): every rank returns the unsharded [B, Q];
  (f) a height the 32-px rule cannot split raises `ValueError` (also inside
      the ranks, before any collective);
  (g) `train()` refuses spatial > 1.

The band of (c) and (e) is 3e-5 px: 1e-5 px would sit below the noise of
the references themselves at this shape, which
`test_the_band_holds_the_references_own_noise` computes.  The port's
unsharded forward moves by 1.34e-5 px (IGEV) and 5.8e-6 px (RAFT) when it
takes the same frame in a batch of two instead of one (oneDNN on), and the
JAX package's own `infer_spatial_sharded` differs from its `model.apply`
by 1.34e-5 px on these inputs: tiles and batches run other convolution
algorithms, and the normalisations sum in another order.  The two ranks
measured 0.95-1.75e-5 px here, the meshes of (e) 1.14-1.53e-5 px.
"""

import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from anystereo_tpu_torch.config import Config, MeshConfig, ModelConfig, TrainConfig, raft_config
from anystereo_tpu_torch.nn import layers
from anystereo_tpu_torch.nn.liif import affinity_features
from anystereo_tpu_torch.nn.model import build_model
from anystereo_tpu_torch.ops import sampling
from anystereo_tpu_torch.ops.coords import _axis_centers
from anystereo_tpu_torch.ops.upsample import unfold3x3
from anystereo_tpu_torch.parallel import mesh as pmesh
from anystereo_tpu_torch.parallel import spatial
from anystereo_tpu_torch.train import trainer as tr
from anystereo_tpu_torch.train.step import make_eval_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, W, MAX_DISP, ITERS, Q = 4, 64, 32, 2, 300
H_PAIR = {0: 64, 1: 96}  # the ops' frame height of each spatial pair (data index)
H_MODEL, CORES = 96, {0: "igev", 1: "raft"}  # the models' frame and each pair's core
H_MESH, B_MESH, Q_MESH = 128, 4, 64
MESHES = [(2, 2), (4, 1), (1, 4)]
OP_ATOL, MODEL_ATOL, JAX_ATOL = 1e-6, 3e-5, 1e-4


def _cfg(core):
    kw = dict(max_disp=MAX_DISP, compute_dtype="float32")
    return ModelConfig(**kw) if core == "igev" else raft_config(**kw)


def _pair(h, b=1, seed=42):
    rng = np.random.RandomState(seed)
    left = (rng.rand(b, h, W, 3) * 255).astype(np.float32)
    right = (rng.rand(b, h, W, 3) * 255).astype(np.float32)
    coords = (rng.rand(b, Q if b == 1 else Q_MESH, 2) * 2 - 1).astype(np.float32)
    return left, right, coords


def _module(m, seed):
    return layers.init_parameters(m, seed)


def _op_cases():
    """name -> (level of the input, dim of the rows, full input shape for a
    frame of h rows, fn(x, rows_at)): `rows_at(s)` is the rows at 1/s the
    caller holds (its tile, or the whole frame)."""
    conv = {
        "conv2d_s1": _module(layers.Conv(6, 5, 3, 1, 1), 1),
        "conv2d_s2": _module(layers.Conv(6, 5, 3, 2, 1), 2),
        "conv2d_7x7": _module(layers.Conv(3, 4, 7, 1, 3), 3),
        "conv2d_1x1_s2": _module(layers.Conv(6, 5, 1, 2, 0), 4),
        "conv2d_k3_s4": _module(layers.Conv(6, 5, 3, 4, 1), 10),
        "depthwise_s2": _module(layers.Conv(6, 6, 3, 2, 1, groups=6, bias=False), 5),
        "conv3d_s1": _module(layers.Conv(4, 3, 3, 1, 1, dims=3), 6),
        "conv3d_s2": _module(layers.Conv(4, 3, 3, 2, 1, dims=3), 7),
        "deconv2d": _module(layers.TorchConvTranspose(6, 5, (4, 4), (2, 2), (1, 1)), 8),
        "deconv3d": _module(layers.TorchConvTranspose(4, 3, (4, 4, 4), (2, 2, 2), (1, 1, 1)), 9),
    }
    gn = layers.GroupNorm(16)
    with torch.no_grad():
        gn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(10))
        gn.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(11))
    nchw = lambda c, s: lambda h: (1, c, h // s, 16)  # noqa: E731
    ncdhw = lambda c, s: lambda h: (1, c, 5, h // s, 16)  # noqa: E731
    nhwc = lambda c, s: lambda h: (1, h // s, 16, c)  # noqa: E731
    cases = {
        "conv2d_s1": (4, -2, nchw(6, 4), lambda x, rows: conv["conv2d_s1"](x)),
        "conv2d_s2": (4, -2, nchw(6, 4), lambda x, rows: conv["conv2d_s2"](x)),
        "conv2d_7x7": (1, -2, nchw(3, 1), lambda x, rows: conv["conv2d_7x7"](x)),
        "conv2d_1x1_s2": (4, -2, nchw(6, 4), lambda x, rows: conv["conv2d_1x1_s2"](x)),
        # one row from the previous rank, the tile's last two rows unread
        "conv2d_k3_s4": (4, -2, nchw(6, 4), lambda x, rows: conv["conv2d_k3_s4"](x)),
        "depthwise_s2": (2, -2, nchw(6, 2), lambda x, rows: conv["depthwise_s2"](x)),
        "conv3d_s1": (4, -2, ncdhw(4, 4), lambda x, rows: conv["conv3d_s1"](x)),
        "conv3d_s2": (4, -2, ncdhw(4, 4), lambda x, rows: conv["conv3d_s2"](x)),
        "deconv2d": (32, -2, nchw(6, 32), lambda x, rows: conv["deconv2d"](x)),
        "deconv3d": (8, -2, ncdhw(4, 8), lambda x, rows: conv["deconv3d"](x)),
        "group_norm": (4, -2, nchw(16, 4), lambda x, rows: gn(x)),
        "instance_norm": (4, -2, nchw(6, 4), lambda x, rows: layers.instance_norm(x)),
        "instance_norm_3d": (8, -2, ncdhw(4, 8), lambda x, rows: layers.instance_norm(x)),
        "global_avg_pool": (4, 1, nhwc(6, 4), lambda x, rows: sampling.global_avg_pool(x)),
        "avg_pool_3_2_1": (4, 1, nhwc(6, 4), lambda x, rows: sampling.avg_pool2d(x, 3, 2, 1)),
        "avg_pool_5_4_1": (4, 1, nhwc(6, 4), lambda x, rows: sampling.avg_pool2d(x, 5, 4, 1)),
        "interp_up": (16, 1, nhwc(3, 16), lambda x, rows: sampling.interp_bilinear(x, (rows(8), 24))),
        "interp_down": (4, 1, nhwc(3, 4), lambda x, rows: sampling.interp_bilinear(x, (rows(8), 12))),
        "nearest_resize": (8, 1, nhwc(3, 8), lambda x, rows: sampling.nearest_resize(x, (rows(4), 32))),
        "nearest_dense_gather": (4, 1, nhwc(3, 4), lambda x, rows: sampling.nearest_dense_gather(
            x, _axis_centers(rows(1), rows=True), _axis_centers(W))[0]),
        "unfold3x3": (4, 1, nhwc(2, 4), lambda x, rows: unfold3x3(x)),
        "liif_neighbours_d1": (4, 1, nhwc(5, 4), lambda x, rows: affinity_features(x, (3, 3), 1)),
        "liif_neighbours_d4": (2, 1, nhwc(5, 2), lambda x, rows: affinity_features(x, (3, 3), 4)),
    }
    return cases


def _op_input(name, shape_fn, h):
    rng = np.random.RandomState(sum(map(ord, name)))
    return torch.from_numpy((rng.randn(*shape_fn(h)) * 2 + 0.5).astype(np.float32))


def _run_ops(group, h):
    """Each op on this rank's tile of a frame of h rows: name -> output tile."""
    out = {}
    with torch.no_grad(), spatial.spatial_context(group, h) as ctx:
        rank = ctx.net.rank

        def rows(s):
            a, b = ctx.tiles(s)[rank]
            return b - a

        for name, (level, dim, shape_fn, fn) in _op_cases().items():
            x = _op_input(name, shape_fn, h)
            a, b = ctx.tiles(level)[rank]
            out[name] = fn(x.narrow(dim % x.dim(), a, b - a), rows)
    return out


def rank_main(rank, port, out):
    """One rank of the four (its own process): every case above, results to
    `out/rank<rank>.pt`."""
    torch.set_num_threads(1)
    os.environ.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES=str(WORLD), PROCESS_ID=str(rank))
    assert pmesh.maybe_initialize_distributed(require=True, device="cpu")
    try:
        res = {}
        block = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)[4 * rank:4 * rank + 4]
        res["halo"] = {h: spatial.halo_exchange(block, h, None, axis=0) for h in (1, 2)}
        grid = pmesh.make_mesh(MeshConfig(data=2, spatial=2))
        pair = grid.data_index
        res["ops"] = _run_ops(grid.spatial_group, H_PAIR[pair])
        with spatial.spatial_context(grid.spatial_group, H_PAIR[pair]) as ctx:
            a, b = ctx.tiles(4)[ctx.net.rank]
            try:  # a global row one past the halo below the tile
                ctx.take_rows(torch.zeros(1, b - a, 4, 1), torch.tensor([b + spatial.GATHER_HALO]), 1)
            except ValueError as e:
                res["stray"] = str(e)
        core = CORES[pair]
        model = build_model(_cfg(core), "cpu")
        model.load_state_dict(torch.load(os.path.join(out, f"{core}.pt"), weights_only=True), strict=True)
        left, right, coords = (torch.from_numpy(a) for a in _pair(H_MODEL))
        res["dense"] = spatial.infer_spatial_sharded(model, None, left, right, None, None, grid.spatial_group,
                                                     iters=ITERS)
        stats = {}
        res["queries"] = spatial.infer_spatial_sharded(model, None, left, right, coords, None,
                                                       grid.spatial_group, iters=ITERS, stats=stats)
        res["stats"] = stats
        try:
            spatial.infer_spatial_sharded(model, None, left[:, :80], right[:, :80], None, None,
                                          grid.spatial_group, iters=ITERS)
        except ValueError as e:
            res["refused"] = str(e)
        igev = build_model(_cfg("igev"), "cpu")
        igev.load_state_dict(torch.load(os.path.join(out, "igev.pt"), weights_only=True), strict=True)
        left, right, coords = (torch.from_numpy(a) for a in _pair(H_MESH, B_MESH, seed=5))
        scale = torch.full((B_MESH,), 1.5)
        for data, sp in MESHES:
            step = make_eval_step(igev, ITERS, "cpu", mesh=pmesh.make_mesh(MeshConfig(data=data, spatial=sp)))
            res[("mesh", data, sp)] = step(left, right, coords, scale)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_models():
    """The JAX models and seeded variables of both cores (jax is imported
    here, not at the top: the ranks import this module)."""
    import jax
    from anystereo_tpu.config import ModelConfig as JaxConfig
    from anystereo_tpu.config import raft_config as jax_raft_config
    from anystereo_tpu.nn.model import AnyStereo as JaxAnyStereo
    from test_torch_model import _seeded_variables

    left, right, _ = _pair(H_MODEL)
    out = {}
    for core in CORES.values():
        kw = dict(max_disp=MAX_DISP, compute_dtype="float32")
        jm = JaxAnyStereo(JaxConfig(**kw) if core == "igev" else jax_raft_config(**kw))
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), left, right, iters=1, mode="eval"))
        out[core] = jm, _seeded_variables(shapes)
    return out


def _jax_references(models):
    """The JAX package's unsharded dense and query forwards of both cores
    (one jit each), and its `infer_spatial_sharded` at the IGEV queries on
    2 virtual devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from anystereo_tpu.parallel.spatial import infer_spatial_sharded

    left, right, coords = (jnp.asarray(a) for a in _pair(H_MODEL))
    out = {}
    for core, (jm, v) in models.items():
        both = jax.jit(lambda v, l, r, q: (jm.apply(v, l, r, iters=ITERS, mode="eval").disp_final,
                                           jm.apply(v, l, r, iters=ITERS, coords=q, mode="eval").disp_final))
        out[core] = tuple(np.asarray(a) for a in both(v, left, right, coords))
    jm, v = models["igev"]
    devices = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("data", "spatial"))
    out["igev_sharded"] = np.asarray(infer_spatial_sharded(jm, v["params"], left, right, coords,
                                                           jnp.ones((1,), jnp.float32), devices, iters=ITERS))
    return out


def _port_references(out):
    """The port's unsharded forwards on the ranks' inputs, on two intra-op
    threads (the test process's own count is restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return _port_forwards(out)
    finally:
        torch.set_num_threads(n)


def _port_forwards(out):
    ref = {}
    with torch.no_grad():
        for core in CORES.values():
            model = build_model(_cfg(core), "cpu")
            model.load_state_dict(torch.load(os.path.join(out, f"{core}.pt"), weights_only=True), strict=True)
            left, right, coords = (torch.from_numpy(a) for a in _pair(H_MODEL))
            ref[core] = (model(left, right, iters=ITERS).disp_final,
                         model(left, right, iters=ITERS, coords=coords).disp_final)
            # the same frame in a batch of two: the forward's own order noise
            ref[core, "pair"] = model(torch.cat([left, left]), torch.cat([right, right]),
                                      iters=ITERS).disp_final[:1]
            if core == "igev":
                left, right, coords = (torch.from_numpy(a) for a in _pair(H_MESH, B_MESH, seed=5))
                ref["mesh"] = model(left, right, iters=ITERS, coords=coords, scale=torch.full((B_MESH,), 1.5),
                                    mode="eval").disp_final
        ref["ops"] = {h: {name: fn(_op_input(name, shape_fn, h), lambda s: h // s)
                          for name, (_, _, shape_fn, fn) in _op_cases().items()} for h in H_PAIR.values()}
    return ref


def _jax_halo(halo):
    """The JAX package's `halo_exchange` under `shard_map` on 4 virtual
    devices, of the 16x8 ramp split in 4 along rows: [4, 4 + 2*halo, 8]."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from anystereo_tpu.parallel.spatial import halo_exchange

    devices = Mesh(np.array(jax.devices()[:WORLD]), ("s",))
    x = jnp.arange(16 * 8, dtype=jnp.float32).reshape(16, 8)
    f = shard_map(lambda blk: halo_exchange(blk, halo=halo, axis_name="s", axis=0), mesh=devices,
                  in_specs=P("s", None), out_specs=P("s", None))
    return np.asarray(f(x)).reshape(WORLD, 4 + 2 * halo, 8)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The four ranks' results, and the references computed while they run."""
    from anystereo_tpu_torch.utils.weights import from_flax

    out = str(tmp_path_factory.mktemp("spatial"))
    models = _jax_models()
    for core, (_, variables) in models.items():
        torch.save(from_flax(variables), os.path.join(out, f"{core}.pt"))
    port = _free_port()
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import test_torch_spatial as t; "
            "t.rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", code, os.path.join(REPO, "tests"), str(r), str(port), out],
                              env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        jax_ref = _jax_references(models)
        jax_ref["halo"] = {h: _jax_halo(h) for h in (1, 2)}
        port_ref = _port_references(out)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return SimpleNamespace(jax=jax_ref, port=port_ref, ranks=[
        torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=True) for r in range(WORLD)])


def _pairs():
    """(data index, its two ranks) of the 2 x 2 mesh."""
    return [(d, (2 * d, 2 * d + 1)) for d in range(2)]


@pytest.mark.parametrize("halo", [1, 2])
def test_halo_exchange_matches_jax(run, halo):
    want = run.jax["halo"][halo]
    for rank, res in enumerate(run.ranks):
        np.testing.assert_array_equal(res["halo"][halo].numpy(), want[rank])


@pytest.mark.parametrize("tiles", ["even", "uneven"])
@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_coupling_op_on_tiles_matches_the_whole_frame(run, name, tiles):
    """The op on each rank's tile of the rows, the tiles stacked in rank
    order, against the op on the whole frame: 64 rows as 32 + 32, 96 as
    64 + 32 (uneven)."""
    pair = 0 if tiles == "even" else 1
    level, dim, _, _ = _op_cases()[name]
    want = run.port["ops"][H_PAIR[pair]][name]
    parts = [run.ranks[r]["ops"][name] for r in _pairs()[pair][1]]
    if name == "global_avg_pool":  # one value for the frame: every rank holds it
        got = parts
    else:
        got = [torch.cat(parts, dim % want.dim())]
    for g in got:
        assert g.shape == want.shape, (g.shape, want.shape)
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=0, atol=OP_ATOL)


@pytest.mark.parametrize("decode", ["dense", "queries"])
@pytest.mark.parametrize("core", ["igev", "raft"])
def test_sharded_forward_matches_the_port(run, core, decode):
    """Both ranks of the pair return the whole result, in the caller's
    order: the port's unsharded forward's within MODEL_ATOL (the module
    docstring says why not 1e-5)."""
    pair = [d for d, c in CORES.items() if c == core][0]
    want = run.port[core][decode == "queries"]
    for r in _pairs()[pair][1]:
        got = run.ranks[r][decode]
        assert got.shape == want.shape and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=MODEL_ATOL)


@pytest.mark.parametrize("decode", ["dense", "queries"])
@pytest.mark.parametrize("core", ["igev", "raft"])
def test_sharded_forward_matches_jax(run, core, decode):
    """The same against the JAX package's unsharded `model.apply` on the same
    weights (its own `tests/test_spatial.py` holds its sharded forward to
    that function); the IGEV queries also against its `infer_spatial_sharded`."""
    pair = [d for d, c in CORES.items() if c == core][0]
    wants = [run.jax[core][decode == "queries"]]
    if core == "igev" and decode == "queries":
        wants.append(run.jax["igev_sharded"])
    for r in _pairs()[pair][1]:
        for want in wants:
            np.testing.assert_allclose(run.ranks[r][decode].numpy(), want, rtol=0, atol=JAX_ATOL)


def test_the_band_holds_the_references_own_noise(run):
    """MODEL_ATOL covers the noise of the references themselves: the port's
    unsharded forward on the same frame in a batch of two, and the JAX
    package's own `infer_spatial_sharded` against its `model.apply`."""
    for core in CORES.values():
        noise = float((run.port[core, "pair"] - run.port[core][0]).abs().max())
        assert noise < MODEL_ATOL, (core, noise)
    assert float(np.abs(run.jax["igev_sharded"] - run.jax["igev"][1]).max()) < MODEL_ATOL


def test_a_rank_decodes_only_its_queries(run):
    """The query decode's collectives: each rank of a pair made the same
    ones (a rank that skipped one would have deadlocked its pair)."""
    for _, ranks in _pairs():
        a, b = (run.ranks[r]["stats"] for r in ranks)
        assert {k: v for k, v in a.items() if k != "ms"} == {k: v for k, v in b.items() if k != "ms"}
        assert a["exchange"] > 0 and a["reduction"] > 0 and a["gather"] == 1


@pytest.mark.parametrize("data,sp", MESHES)
def test_eval_step_over_a_mesh(run, data, sp):
    """`make_eval_step(mesh=...)`: every rank returns the unsharded [B, Q]
    (batch slices over `data`, rows over `spatial`)."""
    want = run.port["mesh"]
    for res in run.ranks:
        got = res[("mesh", data, sp)]
        assert got.shape == want.shape == (B_MESH, Q_MESH)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=MODEL_ATOL)


@pytest.mark.parametrize("height,ranks,want", [
    (1504, 2, (0, 768, 1504)), (96, 2, (0, 64, 96)), (128, 4, (0, 32, 64, 96, 128)),
    (80, 2, ValueError), (32, 2, ValueError), (1500, 2, ValueError),
])
def test_row_partition(height, ranks, want):
    """Whole 32-px rows, the first tiles one unit taller; an H the rule
    cannot split raises ValueError with the numbers."""
    if isinstance(want, tuple):
        assert spatial.row_partition(height, ranks) == want
    else:
        with pytest.raises(want, match=str(height)):
            spatial.row_partition(height, ranks)


def test_ranks_refuse_a_height_they_cannot_split(run):
    for res in run.ranks:
        assert "height 80 cannot be split into 2 tiles" in res["refused"]


def test_a_stray_row_index_raises(run):
    """A nearest gather's row index outside the tile and its halo raises
    rather than read another row."""
    for res in run.ranks:
        assert "fall outside the tile and its halo" in res["stray"]


def test_train_refuses_the_spatial_axis(monkeypatch):
    monkeypatch.setattr(tr, "process_topology", lambda: (0, 2))
    cfg = Config(mesh=MeshConfig(data=1, spatial=2), train=TrainConfig())
    with pytest.raises(NotImplementedError, match="only replicates the step"):
        tr.train(cfg, [], device="cpu")


def test_no_context_outside_the_entry_points():
    assert spatial.current() is None and spatial.frame_rows(7) == 7
