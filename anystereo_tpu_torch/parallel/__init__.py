# The JAX package's `replicated` and `batch_sharding` return jax
# NamedShardings, which torch has no counterpart of (ROADMAP "Not to port").
from anystereo_tpu_torch.parallel.mesh import make_mesh, shard_batch  # noqa: F401
