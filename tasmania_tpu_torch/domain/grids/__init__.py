from tasmania_tpu_torch.domain.grids.vertical_coordinates import GalChen3d, Sigma3d, SLEVE3d

__all__ = ["GalChen3d", "Sigma3d", "SLEVE3d"]
