"""The hand-written CUDA kernels' wrappers (counterpart of
``tasmania_tpu/ops/``).  The export loads on first use: the wrappers import
the isentropic core's flux schemes, which import this package."""


def __getattr__(name):
    if name == "fused_advection_step":
        from tasmania_tpu_torch.ops.advection_step import fused_advection_step

        return fused_advection_step
    raise AttributeError(name)


__all__ = ["fused_advection_step"]
