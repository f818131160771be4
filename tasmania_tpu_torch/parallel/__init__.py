"""The 2-D horizontal domain decomposition over ``torch.distributed``
(counterpart of ``tasmania_tpu/parallel/``): the rank grid and the
decomposition (``mesh``), the halo exchange (``halo``), a shard's lateral
boundary (``distributed``), the decomposed timestep (``runner``), the local
rank launcher (``launch``) and ``torchrun`` wiring (``multihost``).

The JAX package's ``make_mesh`` and ``make_hybrid_mesh`` return a
``jax.sharding.Mesh``; the port's counterparts are ``mesh.make_rank_grid``
and ``multihost.make_hybrid_rank_grid``."""

from tasmania_tpu_torch.parallel.halo import halo_exchange
from tasmania_tpu_torch.parallel.mesh import CartesianDecomposition, make_rank_grid
from tasmania_tpu_torch.parallel.multihost import make_hybrid_rank_grid


def __getattr__(name):
    # lazy: the shard's boundary and the runner import the domain and the dycore
    if name in ("DistributedBoundary", "LocalDomain"):
        from tasmania_tpu_torch.parallel import distributed

        return getattr(distributed, name)
    if name == "DistributedModel":
        from tasmania_tpu_torch.parallel.runner import DistributedModel

        return DistributedModel
    raise AttributeError(name)


__all__ = [
    "halo_exchange",
    "CartesianDecomposition",
    "make_rank_grid",
    "make_hybrid_rank_grid",
    "DistributedBoundary",
    "LocalDomain",
    "DistributedModel",
]
