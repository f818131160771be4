"""The 2-D horizontal domain decomposition over ``torch.distributed``
(counterpart of ``tasmania_tpu/parallel/``): the rank grid and the
decomposition (``mesh``), the halo exchange (``halo``), a shard's lateral
boundary (``distributed``), the decomposed timestep (``runner``), the local
rank launcher (``launch``) and ``torchrun`` wiring (``multihost``)."""
