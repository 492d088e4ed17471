"""`parallel/mesh.shard_batch` of the port against the JAX package's
`shard_batch`, which puts a host batch on a mesh with
`NamedSharding(mesh, P("data"))`.

Two gloo ranks on the CPU (subprocesses) each take their rows of a seeded
batch (a nest of a dict, a list and a tuple; float32, int32 and uint8
arrays, one a torch tensor); each rank's rows must equal, exactly, the shard
`jax.device_put` gives the device at the same place of a 2-device CPU mesh.
A 2x2 (data x spatial) mesh is checked without a process group: a rank's
rows depend only on its place on the grid (`RankMesh.data_index`), and the
JAX package gives every device of a data index the same rows.  A batch
that does not split evenly raises `ValueError` on both sides.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from anystereo_tpu_torch.config import MeshConfig
from anystereo_tpu_torch.parallel import mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(b=4):
    rng = np.random.RandomState(7)
    return {"left": rng.rand(b, 6, 10, 3).astype(np.float32),
            "pair": [rng.randint(0, 255, (b, 5), dtype=np.uint8),
                     (rng.randint(-50, 50, (b, 3, 2)).astype(np.int32),)],
            "scale": rng.rand(b).astype(np.float32)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _jax_shards(shape, batch):
    """{mesh position: [each leaf's shard on that device]} of the JAX
    package's `shard_batch` on a CPU mesh of `shape` (data, spatial).  JAX
    is imported here, not at the top: the ranks import this module."""
    import jax

    from anystereo_tpu.config import MeshConfig as JaxMeshConfig
    from anystereo_tpu.parallel import mesh as jmesh

    data, spatial = shape
    jm = jmesh.make_mesh(JaxMeshConfig(data=data, spatial=spatial), jax.devices()[:data * spatial])
    placed = _leaves(jmesh.shard_batch(batch, jm))
    where = {d: pos for pos, d in np.ndenumerate(jm.devices)}
    out = {}
    for leaf in placed:
        for s in leaf.addressable_shards:
            out.setdefault(where[s.device], []).append(np.asarray(s.data))
    return out


def rank_main(rank, port, out):
    """One of two ranks (its own process): the group over gloo, the mesh of
    MeshConfig(data=2), this rank's rows of `_batch()` (one leaf a torch
    tensor) saved to `out`."""
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                                         rank=rank)
    try:
        m = mesh.make_mesh(MeshConfig(data=2))
        batch = _batch()
        batch["scale"] = torch.from_numpy(batch["scale"])
        rows = mesh.shard_batch(batch, m, device="cpu")
        assert isinstance(rows["pair"], list) and isinstance(rows["pair"][1], tuple)
        torch.save({"data_index": m.data_index, "leaves": _leaves(rows)}, os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_take_the_rows_of_a_two_device_mesh(tmp_path):
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import test_torch_shard_batch as t; "
            "t.rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])")
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", code, os.path.join(REPO, "tests"), str(r), str(port),
                               str(tmp_path)], env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    want = _jax_shards((2, 1), _batch())
    logs = [p.communicate(timeout=120)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    for rank in range(2):
        got = torch.load(os.path.join(tmp_path, f"rank{rank}.pt"), weights_only=True)
        assert got["data_index"] == rank
        assert len(got["leaves"]) == len(want[(rank, 0)]) == 4
        for g, w in zip(got["leaves"], want[(rank, 0)]):
            assert g.numpy().dtype == w.dtype
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("data,spatial", [(2, 2), (4, 1), (1, 4)])
def test_every_place_of_a_grid_takes_the_jax_rows(data, spatial):
    batch = _batch(8)
    want = _jax_shards((data, spatial), batch)
    for (d, s), shards in want.items():
        m = mesh.RankMesh(data, spatial, d, s, None, None)
        got = _leaves(mesh.shard_batch(batch, m, device="cpu"))
        for g, w in zip(got, shards):
            assert g.device.type == "cpu" and g.numpy().dtype == w.dtype
            np.testing.assert_array_equal(g.numpy(), w)
    # the rows are a copy: the host batch is not shared
    m = mesh.RankMesh(data, spatial, 0, 0, None, None)
    rows = mesh.shard_batch(batch, m, device="cpu")
    rows["left"].zero_()
    assert batch["left"].any()


def test_a_batch_that_does_not_split_raises():
    batch = _batch(3)
    with pytest.raises(ValueError):
        _jax_shards((2, 1), batch)
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(batch, mesh.RankMesh(2, 1, 0, 0, None, None), device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch({"x": np.float32(1.0)}, mesh.RankMesh(1, 1, 0, 0, None, None), device="cpu")
