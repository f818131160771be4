"""Checkpoint and resume of model states (counterpart of
``tasmania_tpu/utils/checkpoint.py``, which writes orbax checkpoints).

Layout: ``directory/<step>/`` holds ``arrays.pt`` (``torch.save`` of a dict
of host copies of the fields' tensors) and ``meta.json`` (each field's units,
dims and device, and the model time): enough to rebuild the ``FieldArray``
state on load.  A step is written into a temporary directory and renamed to
its number when complete, as orbax does, so a run killed while saving never
leaves a half-written step behind for ``latest_step``.

The save is synchronous: the fields are on the host and on disk when
``save`` returns, so the next step may overwrite their tensors in place.
``wait`` and :meth:`CheckpointManager.wait_until_finished` are kept for the
JAX class's surface.  ``restore(device=...)`` plays the part of the JAX
class's ``sharding=``: it lays the fields out on another device on load, so
a checkpoint written from the card restores onto the CPU.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from datetime import datetime
from typing import Any, Dict, List, Mapping, Optional

import torch

from tasmania_tpu_torch.framework.field import FieldArray

ARRAYS = "arrays.pt"
META = "meta.json"


def _split(state: Mapping[str, Any]):
    """Host copies of the state's tensors and the JSON metadata."""
    arrays: Dict[str, torch.Tensor] = {}
    meta: Dict[str, Any] = {"fields": {}}
    for name, value in state.items():
        if name == "time" and isinstance(value, datetime):
            meta["time"] = value.isoformat()
            continue
        data = value.data if isinstance(value, FieldArray) else torch.as_tensor(value)
        arrays[name] = data.detach().to("cpu", copy=True)
        info = {"units": value.units, "dims": list(value.dims)} if isinstance(value, FieldArray) \
            else {"units": "1", "dims": []}
        meta["fields"][name] = {**info, "device": str(data.device)}
    return arrays, meta


def _join(arrays: Mapping[str, torch.Tensor], meta: Mapping[str, Any], device) -> Dict[str, Any]:
    """The state of :func:`_split`'s parts, each tensor on ``device`` (None:
    the device it was saved from if this process has it, else the CPU).  A
    tensor ``"time"`` (seconds from the run's start) comes back as a tensor."""
    state: Dict[str, Any] = {}
    if "time" in meta:
        state["time"] = datetime.fromisoformat(meta["time"])
    for name, arr in arrays.items():
        info = meta["fields"].get(name, {"units": "1", "dims": []})
        data = arr.to(_target(info.get("device", "cpu")) if device is None else device)
        state[name] = data if name == "time" else FieldArray(data, info["units"], tuple(info["dims"]))
    return state


def _target(saved: str) -> torch.device:
    device = torch.device(saved)
    if device.type == "cuda" and not (torch.cuda.is_available()
                                      and (device.index or 0) < torch.cuda.device_count()):
        return torch.device("cpu")
    return device


class CheckpointManager:
    """Saves model states as numbered steps of ``directory`` and restores
    them; keeps the newest ``max_to_keep`` steps (None: all)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3) -> None:
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def save(self, step: int, state: Mapping[str, Any], *, force: bool = False,
             wait: bool = False) -> bool:
        """Write ``state`` as step ``step``.  Like orbax, a step not newer
        than the latest is not saved (returns False) unless ``force``, which
        replaces a step of the same number.  ``wait`` is accepted for the
        JAX class's surface: the write is complete when this returns."""
        latest = self.latest_step
        if latest is not None and step <= latest and not force:
            return False
        arrays, meta = _split(state)
        tmp = tempfile.mkdtemp(prefix=f".{step}.tmp-", dir=self.directory)
        try:
            torch.save(arrays, os.path.join(tmp, ARRAYS))
            with open(os.path.join(tmp, META), "w") as f:
                json.dump(meta, f)
            final = self._path(step)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._path(old))
        return True

    def restore(self, step: Optional[int] = None, *, device=None) -> Dict[str, Any]:
        """The state saved as ``step`` (default: the latest), its tensors on
        ``device`` (default: each where it was saved from, or the CPU if
        this process has no such device).  ``FileNotFoundError`` if there
        is no such step."""
        if step is None:
            step = self.latest_step
        if step is None or step not in self.all_steps():
            raise FileNotFoundError(f"no checkpoint {'found' if step is None else step} in {self.directory}")
        path = self._path(step)
        arrays = torch.load(os.path.join(path, ARRAYS), map_location="cpu", weights_only=True)
        with open(os.path.join(path, META)) as f:
            meta = json.load(f)
        return _join(arrays, meta, device)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        """The complete steps on disk, oldest first."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isfile(os.path.join(self.directory, name, META)))

    def nbytes(self, step: int) -> int:
        """The bytes step ``step`` takes on disk."""
        path = self._path(step)
        return sum(os.path.getsize(os.path.join(path, name)) for name in os.listdir(path))

    def wait_until_finished(self) -> None:
        """Nothing to wait for: every save is complete when it returns."""

    def close(self) -> None:
        """Nothing to release: the manager holds no open file."""

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
