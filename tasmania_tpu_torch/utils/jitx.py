"""The step loop as one CUDA graph (counterpart of ``tasmania_tpu/utils/jitx.py``,
of the JAX drivers' ``jax.jit`` of every step, which the port's drivers
follow by default on a CUDA device, and of their ``--fused-loop``, which
runs all the steps in one jitted ``lax.fori_loop``).

A model step maps a dict of ``FieldArray``s and the topography height to the
next dict, but reads only some of its fields: the prognostics and a few
recurrences; every pure diagnostic is recomputed inside the step.  The JAX
loop carries only the fields the step reads (``carry_read_set``); here the
same set names the outputs that a graph copies back into its static inputs
after each step.

* :func:`traced_step` runs one step on fields that record which of them the
  step reads (their ``data``); :func:`carry_read_set` keeps the names.  A
  field the step returns unchanged (the same tensor) is not carried: its
  static input is its output.
* :class:`StepBody` is what the graph captures: one step on static input
  buffers, the topography from a device table of the run's scaled profiles
  indexed by a device step counter (the JAX loop forms ``fact · hs`` inside
  the loop), and the copy of the carried outputs back into the inputs.
  It runs eagerly too, on any device.  ``load`` puts a resumed run's fields
  into the buffers and sets the counter to the step it resumes after;
  ``outputs`` views the last step's outputs (a checkpoint or the NaN guard
  between replays), ``fields`` copies them.
* :class:`StepGraph` captures one call of a :class:`StepBody` on the card
  and replays it once a step.  It raises on a CPU device and never falls
  back to eager stepping.

Every scalar a kernel takes is frozen into the graph at capture, so
anything that varies from step to step must reach the step through a
tensor: in the isentropic drivers the topography, in the Burgers driver
the step's start time (its table's rows are the start times, times a
tensor of one), from which the Dirichlet boundary's core computes the
frames on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Set, Tuple

import torch

from tasmania_tpu_torch.framework.field import FieldArray

Fields = Dict[str, FieldArray]
Step = Callable[[Fields, torch.Tensor], Fields]


class _Watched(FieldArray):
    """A ``FieldArray`` that records its name in ``reads`` when its data is
    taken; its shape and dtype are not a read."""

    def __init__(self, field: FieldArray, name: str, reads: Set[str]):
        super().__init__(field.data, field.units, field.dims)
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_reads", reads)

    def __getattribute__(self, attr):
        if attr == "data":
            object.__getattribute__(self, "_reads").add(object.__getattribute__(self, "_name"))
        return object.__getattribute__(self, attr)

    @property
    def shape(self):
        return tuple(object.__getattribute__(self, "data").shape)

    @property
    def dtype(self):
        return object.__getattribute__(self, "data").dtype


def _plain(field: FieldArray) -> FieldArray:
    if isinstance(field, _Watched):
        return FieldArray(object.__getattribute__(field, "data"), field.units, field.dims)
    return field


def traced_step(step: Step, fields: Fields, hs: torch.Tensor) -> Tuple[Fields, Set[str]]:
    """One ``step(fields, hs)``, returning its outputs and the names of the
    fields it carries: those whose data it reads and that it does not return
    unchanged (the same tensor)."""
    reads: Set[str] = set()
    inputs = {k: _plain(v).data for k, v in fields.items()}
    out = step({k: _Watched(_plain(v), k, reads) for k, v in fields.items()}, hs)
    out = {k: _plain(v) for k, v in out.items()}
    unchanged = {k for k, v in out.items() if k in inputs and v.data is inputs[k]}
    return out, reads - unchanged


def carry_read_set(step: Step, fields: Fields, hs: torch.Tensor) -> Set[str]:
    """The names of the fields that one ``step(fields, hs)`` reads and does
    not return unchanged (the step runs once).  The JAX ``carry_read_set``
    also counts a field the step passes through as read."""
    return traced_step(step, fields, hs)[1]


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class StepBody:
    """One step on static input buffers (clones of ``fields``), the
    topography ``facts[i] · hs_steady`` at its ``i``-th call, and the copy
    of the ``carried`` outputs back into the inputs.

    The scaled profiles are formed once, by the same host operation an eager
    loop takes (``fact * hs_steady``), into a device table of a row a fact;
    a device counter, clamped to the last row, picks the row.  ``fields()``
    gives the outputs of the last call."""

    def __init__(self, step: Step, fields: Fields, carried: Set[str], hs_steady: torch.Tensor,
                 facts: Sequence[float]):
        facts = list(facts) or [0.0]
        self.step = step
        self.static = {k: v.with_data(v.data.clone()) for k, v in fields.items()}
        self.carried = sorted(carried)
        self.table = torch.stack([f * hs_steady for f in facts])
        self.counter = torch.zeros(1, dtype=torch.long, device=hs_steady.device)
        self.last = len(facts) - 1
        self.out: Fields = dict(self.static)
        self._owner = {_storage(v.data): k for k, v in self.static.items()}

    def __call__(self) -> Fields:
        row = self.counter.clamp(max=self.last)
        hs = self.table.index_select(0, row)[0]
        out = self.step(dict(self.static), hs)
        aliased = sorted(k for k, v in out.items() if self._owner.get(_storage(v.data), k) != k)
        if aliased:
            raise ValueError(f"StepBody: outputs {aliased} alias another field's input, which "
                             "the copy-back would overwrite")
        for k in self.carried:
            src, dst = out[k].data, self.static[k].data
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src)
        self.counter.add_(1)
        self.out = out
        return out

    def load(self, fields: Fields, counter: int) -> None:
        """Copy ``fields`` (one for each input) into the input buffers and set
        the counter to ``counter``: the next call steps at ``facts[counter]``
        (a run resumed after step ``counter``).  The outputs keep the last
        call's values until the next call."""
        for k, v in self.static.items():
            v.data.copy_(fields[k].data)
        self.counter.fill_(counter)

    def outputs(self) -> Fields:
        """The last call's outputs, not copied: a graph's next replay
        overwrites them."""
        return dict(self.out)

    def fields(self) -> Fields:
        """The last call's outputs, copied out of the buffers a graph reuses."""
        return {k: v.with_data(v.data.clone()) for k, v in self.out.items()}


class StepGraph:
    """A :class:`StepBody` captured once as a CUDA graph on the body's
    device; ``replay(n)`` runs ``n`` steps.  Raises ``ValueError`` on a CPU
    device; a failed capture or replay raises too."""

    def __init__(self, body: StepBody):
        device = body.table.device
        if device.type != "cuda":
            raise ValueError(f"StepGraph: a CUDA graph needs a CUDA device, not {device}")
        self.body = body
        self.graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(device)
        with torch.cuda.device(device), torch.cuda.graph(self.graph):
            body()

    def replay(self, n: int = 1) -> None:
        for _ in range(n):
            self.graph.replay()

    def fields(self) -> Fields:
        return self.body.fields()
