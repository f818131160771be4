"""The two-dimensional viscous Burgers model (counterpart of
``tasmania_tpu/burgers``): advection of orders 1-6, the forward Euler, RK2
and RK3WS steppers, the dynamical core, the diffusion tendency and the Zhao
test case with its exact solution.  The JAX package computes the model in
XLA, outside any Pallas kernel, so the port is plain PyTorch;
``drivers/driver_burgers.py`` replays it on the card as one CUDA graph of
the step."""

from tasmania_tpu_torch.burgers.dynamics.advection import BurgersAdvection
from tasmania_tpu_torch.burgers.dynamics.dycore import BurgersDynamicalCore
from tasmania_tpu_torch.burgers.dynamics.stepper import BurgersStepper
from tasmania_tpu_torch.burgers.physics.diffusion import BurgersHorizontalDiffusion
from tasmania_tpu_torch.burgers.state import ZhaoSolutionFactory, ZhaoStateFactory

__all__ = [
    "BurgersAdvection",
    "BurgersDynamicalCore",
    "BurgersStepper",
    "BurgersHorizontalDiffusion",
    "ZhaoSolutionFactory",
    "ZhaoStateFactory",
]
