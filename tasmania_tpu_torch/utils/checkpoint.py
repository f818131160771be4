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

**Sharded steps** (the JAX class has every device write its own shards and
re-shards on restore, ``tasmania_tpu/utils/checkpoint.py:52-60``,
``:104-150``): ``save(..., model=dm)`` on every rank of a decomposed run
(``parallel/runner.py::DistributedModel``) writes that rank's owned blocks
and the faces just past them to ``rank<r>.pt``; rank 0 writes ``meta.json``
(each field's global shape, dtype, units and dims, the rank grid, the
global cells of every rank's blocks and faces, the time) and renames the
step's temporary directory only after a barrier of the ranks, so a step
that one rank did not finish is never a step.  ``restore(model=...)`` lays
a step out for the grid and rank of ``model`` (a ``DistributedModel``, or
a ``ShardLayout``), whatever grid saved it: it reads only the files of the
ranks whose blocks overlap its window.  Without a model a sharded step
comes back as the global state on one process (the JAX class's fallback
for absent devices); a single-process step restores onto a grid too.  A
block's cells take precedence over a face's where both cover a cell, as
``DistributedModel.gather_state`` takes them.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from datetime import datetime
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from tasmania_tpu_torch.framework.field import FieldArray

ARRAYS = "arrays.pt"
META = "meta.json"
RANK_FILE = "rank{}.pt"


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


def _check_device(device) -> None:
    """Raise if ``device`` is a CUDA device this process does not have: a
    restore asked for the card never falls back to the host."""
    if device is not None and torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"restore onto {device} asked for, but no CUDA device is available")


def _barrier(layout, group) -> None:
    if layout.grid.size > 1:
        dist.barrier(group=group)


def _overlap(a, b):
    """The intersection of two regions (x0, x1, y0, y1), or None."""
    x0, x1, y0, y1 = max(a[0], b[0]), min(a[1], b[1]), max(a[2], b[2]), min(a[3], b[3])
    return (x0, x1, y0, y1) if x0 < x1 and y0 < y1 else None


class CheckpointManager:
    """Saves model states as numbered steps of ``directory`` and restores
    them; keeps the newest ``max_to_keep`` steps (None: all)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3) -> None:
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def save(self, step: int, state: Mapping[str, Any], *, force: bool = False,
             wait: bool = False, model=None) -> bool:
        """Write ``state`` as step ``step``.  Like orbax, a step not newer
        than the latest is not saved (returns False) unless ``force``, which
        replaces a step of the same number.  ``wait`` is accepted for the
        JAX class's surface: the write is complete when this returns.

        With ``model`` (a ``DistributedModel``), every rank of its grid
        calls ``save`` with its owned blocks as ``state`` and the step is
        sharded (module docstring); it returns on every rank once the step
        is complete."""
        latest = self.latest_step
        if latest is not None and step <= latest and not force:
            return False
        if model is not None:
            self._save_sharded(step, state, model)
            return True
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

    def _save_sharded(self, step: int, state: Mapping[str, Any], model) -> None:
        layout, group = model.layout, model.ex.group
        tmp = os.path.join(self.directory, f".{step}.tmp-sharded")
        if layout.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        _barrier(layout, group)
        fields = {n: (v.data if isinstance(v, FieldArray) else v) for n, v in state.items()
                  if n in layout.names}
        tensors = model.checkpoint_parts(fields)
        part = os.path.join(tmp, RANK_FILE.format(layout.rank))
        torch.save({k: t.detach().to("cpu", copy=True) for k, t in tensors.items()}, part + ".part")
        os.rename(part + ".part", part)
        if layout.rank == 0:
            meta: Dict[str, Any] = {
                "sharded": True,
                "grid": list(layout.grid.shape),
                "order": None if layout.grid.order is None else list(layout.grid.order),
                "pads": list(layout.pads),
                "fields": {n: {"units": layout.units[n], "dims": list(layout.dims[n]),
                               "shape": list(layout.global_shape(n, tuple(fields[n].shape[2:]))),
                               "dtype": str(fields[n].dtype).replace("torch.", ""),
                               "device": str(fields[n].device)}
                           for n in layout.names},
                "regions": {str(r): layout.regions(r) for r in range(layout.grid.size)},
            }
            if isinstance(state.get("time"), datetime):
                meta["time"] = state["time"].isoformat()
            with open(os.path.join(tmp, META), "w") as f:
                json.dump(meta, f)
        _barrier(layout, group)
        if layout.rank == 0:
            final = self._path(step)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            if self.max_to_keep is not None:
                for old in self.all_steps()[:-self.max_to_keep]:
                    shutil.rmtree(self._path(old))
        _barrier(layout, group)

    def _step_path(self, step: Optional[int]) -> Tuple[int, str]:
        if step is None:
            step = self.latest_step
        if step is None or step not in self.all_steps():
            raise FileNotFoundError(f"no checkpoint {'found' if step is None else step} in {self.directory}")
        return step, self._path(step)

    def meta(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The metadata of step ``step`` (default: the latest)."""
        with open(os.path.join(self._step_path(step)[1], META)) as f:
            return json.load(f)

    def restore(self, step: Optional[int] = None, *, model=None, device=None) -> Dict[str, Any]:
        """The state saved as ``step`` (default: the latest), its tensors on
        ``device`` (default: each where it was saved from, or the CPU if
        this process has no such device; with a ``model``, the model's
        device).  ``FileNotFoundError`` if there is no such step;
        ``RuntimeError`` if ``device`` is a CUDA device this process lacks.

        With ``model`` (a ``DistributedModel`` or a ``ShardLayout``), the
        owned blocks of its rank, laid out for its grid whatever grid saved
        the step (a ``DistributedModel`` keeps the faces past them in its
        ``last_faces``); without one, the global state (a sharded step
        assembled on this process)."""
        _check_device(device)
        step, path = self._step_path(step)
        meta = self.meta(step)
        if model is not None:
            layout = getattr(model, "layout", model)
            device = device if device is not None else getattr(model, "device", None)
            windows = self.restore_windows(step, layout, device=device)
            if hasattr(model, "scatter_windows"):
                blocks = model.scatter_windows(windows)
            else:
                blocks = layout.split_windows(windows)[0]
            state = {} if "time" not in meta else {"time": datetime.fromisoformat(meta["time"])}
            state.update({n: FieldArray(b, meta["fields"][n]["units"], tuple(meta["fields"][n]["dims"]))
                          for n, b in blocks.items()})
            return state
        if meta.get("sharded"):
            fields = meta["fields"]
            arrays = self._assemble(path, meta, {n: (0, f["shape"][0], 0, f["shape"][1])
                                                 for n, f in fields.items()})
            return _join(arrays, meta, device)
        arrays = torch.load(os.path.join(path, ARRAYS), map_location="cpu", weights_only=True)
        return _join(arrays, meta, device)

    def restore_windows(self, step: Optional[int], layout, *, device=None) -> Dict[str, torch.Tensor]:
        """The window of ``layout``'s rank (``ShardLayout.window``: its
        owned block and, staggered, the face past it) of each field that
        both the step and the layout hold, on ``device`` (default the
        CPU).  From a sharded step only the files of the ranks whose blocks
        or faces overlap the window are read."""
        _check_device(device)
        step, path = self._step_path(step)
        meta = self.meta(step)
        names = [n for n in layout.names if n in meta["fields"]]
        if meta.get("sharded"):
            for n in names:
                want = list(layout.global_shape(n, tuple(meta["fields"][n]["shape"][2:])))
                if meta["fields"][n]["shape"] != want:
                    raise ValueError(f"checkpoint step {step}: {n} is {meta['fields'][n]['shape']} "
                                     f"globally, the layout's grid needs {want}")
            windows = self._assemble(path, meta, {n: layout.window(n) for n in names})
        else:
            arrays = torch.load(os.path.join(path, ARRAYS), map_location="cpu", weights_only=True)
            windows = {}
            for n in names:
                if layout.degenerate:
                    windows[n] = arrays[n]
                else:
                    x0, x1, y0, y1 = layout.window(n)
                    windows[n] = layout.physical(arrays[n], n)[x0:x1, y0:y1]
        device = torch.device("cpu") if device is None else torch.device(device)
        return {n: w.to(device) for n, w in windows.items()}

    def _assemble(self, path: str, meta, targets) -> Dict[str, torch.Tensor]:
        """Each target region of each field from the blocks and faces of the
        ranks that overlap it (faces first, then blocks over them)."""
        fields = meta["fields"]
        out, covered, loaded = {}, {}, {}
        for n, (x0, x1, y0, y1) in targets.items():
            rest = tuple(fields[n]["shape"][2:])
            out[n] = torch.empty((x1 - x0, y1 - y0) + rest, dtype=getattr(torch, fields[n]["dtype"]))
            covered[n] = torch.zeros((x1 - x0, y1 - y0), dtype=torch.bool)
        for kind in ("face", "block"):
            for r, regions in meta["regions"].items():
                for n, target in targets.items():
                    region = regions.get(f"{kind}:{n}")
                    hit = None if region is None else _overlap(region, target)
                    if hit is None:
                        continue
                    if r not in loaded:
                        loaded[r] = torch.load(os.path.join(path, RANK_FILE.format(r)),
                                               map_location="cpu", weights_only=True, mmap=True)
                    src = loaded[r][f"{kind}:{n}"]
                    hx0, hx1, hy0, hy1 = hit
                    dst = (slice(hx0 - target[0], hx1 - target[0]), slice(hy0 - target[2], hy1 - target[2]))
                    out[n][dst] = src[hx0 - region[0] : hx1 - region[0], hy0 - region[2] : hy1 - region[2]]
                    covered[n][dst] = True
        gaps = sorted(n for n, c in covered.items() if not bool(c.all()))
        if gaps:
            raise ValueError(f"checkpoint {path}: no rank's blocks cover the window of {gaps}")
        return out

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        """The complete steps on disk, oldest first: a step directory with
        its metadata and, if sharded, every rank's file."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and self._complete(os.path.join(self.directory, name)))

    @staticmethod
    def _complete(path: str) -> bool:
        meta_path = os.path.join(path, META)
        if not os.path.isfile(meta_path):
            return False
        with open(meta_path) as f:
            meta = json.load(f)
        return all(os.path.isfile(os.path.join(path, RANK_FILE.format(r)))
                   for r in meta.get("regions", {}))

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
