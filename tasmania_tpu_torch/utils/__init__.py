"""Utilities (counterpart of ``tasmania_tpu/utils/__init__.py``).

The exports load on first use: the checkpoint manager and the HDF5 monitor
import modules of the framework, and ``h5py`` only where it is used."""


def __getattr__(name):
    if name == "CheckpointManager":
        from tasmania_tpu_torch.utils.checkpoint import CheckpointManager

        return CheckpointManager
    if name in ("HDF5Monitor", "load_hdf5_dataset"):
        from tasmania_tpu_torch.utils import iox

        return getattr(iox, name)
    raise AttributeError(name)


__all__ = ["CheckpointManager", "HDF5Monitor", "load_hdf5_dataset"]
