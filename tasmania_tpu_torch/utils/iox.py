"""State I/O: store model states with the grid's metadata, write them to a
file and load them back (counterpart of ``tasmania_tpu/utils/iox.py``).

Two containers behind one interface, in the JAX package's file layout, so a
file written by either package loads in the other:

* :class:`NetCDFMonitor` / :func:`load_netcdf_dataset`: classic NetCDF
  (64-bit offset, through ``scipy.io.netcdf_file``).  Every stored field is
  a variable over an unlimited ``time`` dimension and its own dimensions,
  with its units as an attribute; what rebuilds the domain (grid, boundary,
  topography) is in global attributes.  The loader also reads NetCDF-4
  files, which are HDF5 containers, through ``h5py``.
* :class:`HDF5Monitor` / :func:`load_hdf5_dataset`: HDF5, one group a
  stored state.

``h5py`` is imported only by the functions that use it: the NetCDF path
needs only scipy.  A monitor copies each tensor to host memory when it
stores a state, so a later in-place step cannot change the stored snapshot.
The loaders return the fields as tensors on ``device`` (the CPU by
default), in the stored dtype.

One difference from the JAX package's files: a topography parameter given
as a ``FieldArray`` (the mountain's height, widths and centre) is written in
metres, the unit the loaders read it in; the JAX package writes its number
in the given units, so a height given in km reloads there as metres.
"""

from __future__ import annotations

import json
from datetime import datetime, timedelta
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions

#: topography parameters the loaders rebuild as lengths in metres
_TOPO_LENGTHS = ("max_height", "width_x", "width_y", "center_x", "center_y")


def _domain_attrs(domain) -> Dict[str, Any]:
    """Global attributes that rebuild ``domain`` on load."""
    pg = domain.physical_grid
    topo = pg.topography
    x, y = np.asarray(pg.x.data), np.asarray(pg.y.data)
    zhl = np.asarray(pg.z_on_interface_levels.data)
    return {
        "nx": pg.nx,
        "ny": pg.ny,
        "nz": pg.nz,
        "domain_x": [float(x[0]), float(x[-1])],
        "x_units": pg.x.units,
        "domain_y": [float(y[0]), float(y[-1])],
        "y_units": pg.y.units,
        "domain_z": [float(zhl[0]), float(zhl[-1])],
        "z_units": pg.z.units,
        "topo_type": getattr(topo, "type", "flat") or "flat",
        "topo_time_s": topo.time.total_seconds(),
        "hb_type": domain.horizontal_boundary.type,
        "nb": domain.horizontal_boundary.nb,
        "hb_kwargs": json.dumps(
            {
                k: v
                for k, v in domain.horizontal_boundary.kwargs.items()
                if isinstance(v, (int, float, str, bool))
            }
        ),
        "topo_kwargs": json.dumps(
            {
                k: (
                    float(np.asarray(v.to_units("m").data if k in _TOPO_LENGTHS else v.data))
                    if isinstance(v, FieldArray)
                    else v
                )
                for k, v in getattr(topo, "kwargs", {}).items()
                if isinstance(v, (int, float, str, bool, FieldArray))
            }
        ),
    }


def _scalar(value):
    """A number from an attribute read back as a scalar or 1-element array."""
    return np.asarray(value).reshape(-1)[0]


def _domain_from_attrs(attrs: Mapping[str, Any], storage_options: StorageOptions):
    """Rebuild a ``Domain`` from :func:`_domain_attrs`'s attributes."""
    from tasmania_tpu_torch.domain.domain import Domain

    topo_kwargs = json.loads(attrs.get("topo_kwargs", "{}"))
    if float(_scalar(attrs["topo_time_s"])) > 0:
        topo_kwargs["time"] = timedelta(seconds=float(_scalar(attrs["topo_time_s"])))
    for key in _TOPO_LENGTHS:
        if key in topo_kwargs:
            topo_kwargs[key] = FieldArray(np.asarray(topo_kwargs[key]), "m", ())
    return Domain(
        FieldArray(np.asarray(attrs["domain_x"]), attrs["x_units"], ("x",)),
        int(_scalar(attrs["nx"])),
        FieldArray(np.asarray(attrs["domain_y"]), attrs["y_units"], ("y",)),
        int(_scalar(attrs["ny"])),
        FieldArray(np.asarray(attrs["domain_z"]), attrs["z_units"], ("z",)),
        int(_scalar(attrs["nz"])),
        horizontal_boundary_type=attrs["hb_type"],
        nb=int(_scalar(attrs["nb"])),
        horizontal_boundary_kwargs=json.loads(attrs.get("hb_kwargs", "{}")),
        topography_type=str(attrs["topo_type"]),
        topography_kwargs=topo_kwargs,
        storage_options=storage_options,
    )


def _loaded(fields: Mapping[str, Tuple[np.ndarray, str, Tuple[str, ...]]], device,
            dtype: Optional[torch.dtype]):
    """The storage options of a loaded file's domain (``dtype``, else the
    stored fields' floating type, else float64) and a function that makes
    a field a tensor ``FieldArray`` on ``device``."""
    if dtype is None:
        stored = [a.dtype for a, _, _ in fields.values() if np.issubdtype(a.dtype, np.floating)]
        dtype = torch.from_numpy(np.zeros(0, stored[0].newbyteorder("="))).dtype if stored else torch.float64

    def field(arr: np.ndarray, units: str, dims) -> FieldArray:
        arr = np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder("="))
        return FieldArray(torch.from_numpy(arr).to(device), units, tuple(dims))

    return StorageOptions(dtype=dtype, device=device), field


class StateMonitor:
    """Accumulates states for writing: ``store`` takes a host copy of every
    field (or of ``store_names``), ``write`` writes the file."""

    def __init__(
        self,
        filename: str,
        domain=None,
        grid_type: str = "numerical",
        store_names: Optional[Tuple[str, ...]] = None,
    ) -> None:
        self._filename = filename
        self._domain = domain
        self._grid_type = grid_type
        self._store_names = store_names
        self._states: List[Dict[str, Any]] = []

    def store(self, state: Mapping[str, Any]) -> None:
        snap: Dict[str, Any] = {}
        for name, fa in state.items():
            if name == "time":
                if not isinstance(fa, datetime):
                    raise TypeError("a stored state's time must be a datetime "
                                    "(interop.state_to_numpy converts a tensor time)")
                snap["time"] = fa
                continue
            if self._store_names and name not in self._store_names:
                continue
            if isinstance(fa, FieldArray):
                snap[name] = (_host_copy(fa.data), fa.units, fa.dims)
            else:
                snap[name] = (_host_copy(fa), "1", ())
        self._states.append(snap)

    def write(self) -> None:
        raise NotImplementedError


def _host_copy(x) -> np.ndarray:
    """A host numpy copy of a tensor or array that shares no memory with it."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


class NetCDFMonitor(StateMonitor):
    """Writes the stored states to a classic NetCDF file.

    Layout: one unlimited ``time`` dimension (seconds since the first stored
    state's time, whose ISO form is in the ``units`` attribute); a variable
    ``(time, *dims)`` a field, with a ``units`` attribute, its dimensions
    named after the field's dims (``x``, ``x_at_u_locations``, ...); the
    domain's metadata as global attributes."""

    def write(self) -> None:
        from scipy.io import netcdf_file

        if not self._states:
            raise ValueError("no states stored")
        first = self._states[0]
        names = sorted(k for k in first if k != "time")
        for snap in self._states:
            if sorted(k for k in snap if k != "time") != names:
                raise ValueError("all stored states must hold the same fields")

        with netcdf_file(self._filename, "w", version=2) as f:
            if self._domain is not None:
                for k, v in _domain_attrs(self._domain).items():
                    setattr(f, k, v)
            f.grid_type = self._grid_type

            f.createDimension("time", None)
            times = [s.get("time") for s in self._states]
            tvar = f.createVariable("time", "f8", ("time",))
            if times[0] is not None:
                epoch = times[0]
                tvar.units = f"seconds since {epoch.isoformat()}"
                tvar[:] = np.asarray([(t - epoch).total_seconds() for t in times], dtype="f8")
            else:
                tvar.units = "snapshot index"
                tvar[:] = np.arange(len(self._states), dtype="f8")

            # spatial dimensions: named by the field dims, sized per field
            dim_sizes: Dict[str, int] = {}
            for name in names:
                arr, _, dims = first[name]
                for ax, d in enumerate(dims):
                    d = d or f"{name}_dim{ax}"
                    if d in dim_sizes:
                        if dim_sizes[d] != arr.shape[ax]:
                            raise ValueError(f"dimension {d} has conflicting sizes")
                    else:
                        dim_sizes[d] = arr.shape[ax]
                        f.createDimension(d, arr.shape[ax])

            for name in names:
                arr, units, dims = first[name]
                dims = tuple(d or f"{name}_dim{ax}" for ax, d in enumerate(dims))
                var = f.createVariable(name, arr.dtype.newbyteorder("="), ("time",) + dims)
                var.units = units
                var[:] = np.stack([snap[name][0] for snap in self._states], axis=0)


def _dec(x):
    return x.decode() if isinstance(x, bytes) else x


def load_netcdf_dataset(filename: str, *, device="cpu", dtype: Optional[torch.dtype] = None):
    """``(domain, grid_type, states)`` from a :class:`NetCDFMonitor` file
    (classic NetCDF, through scipy) or from a NetCDF-4 file (HDF5, through
    ``h5py``: the layout netCDF4 and xarray writers make).  The fields are
    tensors on ``device``; the domain (None if the file has no domain
    attributes) is built with ``dtype``, by default the stored fields'."""
    from scipy.io import netcdf_file

    try:
        f = netcdf_file(filename, "r", mmap=False)
    except (TypeError, ValueError, OSError):
        # not a classic NetCDF file; NetCDF-4 files are HDF5 containers
        return _load_netcdf4_dataset(filename, device, dtype)
    with f:
        attrs = {k: _dec(v) for k, v in f._attributes.items()}
        grid_type = attrs.get("grid_type", "numerical")

        tvar = f.variables["time"]
        tunits = _dec(tvar.units)
        offsets = np.asarray(tvar[:], dtype="f8")
        epoch = None
        if tunits.startswith("seconds since "):
            epoch = datetime.fromisoformat(tunits[len("seconds since "):])

        fields = {
            name: (np.array(var[:]), _dec(var.units), tuple(var.dimensions[1:]))
            for name, var in f.variables.items()
            if name != "time"
        }
    return _assemble(attrs, grid_type, epoch, offsets, fields, device, dtype)


def _assemble(attrs, grid_type, epoch, offsets, fields, device, dtype):
    """The loaders' result from the file's attributes, times and fields
    (each ``(array over time, units, dims)``)."""
    so, field = _loaded(fields, device, dtype)
    domain = _domain_from_attrs(attrs, so) if "nx" in attrs else None
    states: List[Dict[str, Any]] = []
    for it in range(len(offsets)):
        state: Dict[str, Any] = {}
        if epoch is not None:
            state["time"] = epoch + timedelta(seconds=float(offsets[it]))
        for name, (arr, units, dims) in fields.items():
            state[name] = field(arr[it], units, dims)
        states.append(state)
    return domain, grid_type, states


def _load_netcdf4_dataset(filename: str, device, dtype):
    """NetCDF-4 through h5py: data variables are root datasets whose
    dimensions are dimension scales (``CLASS=DIMENSION_SCALE`` on the
    dimension datasets, ``DIMENSION_LIST`` references on the variables)."""
    import h5py

    def dec(x):
        if isinstance(x, bytes):
            return x.decode()
        if isinstance(x, np.ndarray):
            if x.ndim == 0:
                return dec(x[()])
            return [dec(v) for v in x.tolist()]
        if isinstance(x, np.generic):
            return x.item()
        return x

    with h5py.File(filename, "r") as f:
        attrs = {k: dec(v) for k, v in f.attrs.items() if not k.startswith("_NC")}
        grid_type = attrs.get("grid_type", "numerical")

        def dims_of(ds):
            if "DIMENSION_LIST" in ds.attrs:
                names = []
                for refs in ds.attrs["DIMENSION_LIST"]:
                    refs = list(refs) if np.ndim(refs) else [refs]
                    names.append(f[refs[0]].name.rsplit("/", 1)[-1] if refs else "")
                return tuple(names)
            if ds.attrs.get("CLASS") in (b"DIMENSION_SCALE", "DIMENSION_SCALE"):
                # a coordinate variable is its own (only) dimension
                return (ds.name.rsplit("/", 1)[-1],) + ("",) * (ds.ndim - 1)
            return ("",) * ds.ndim

        variables = {k: v for k, v in f.items() if isinstance(v, h5py.Dataset)}
        if "time" not in variables:
            raise ValueError(f"{filename}: NetCDF-4 file has no 'time' variable")
        tvar = variables["time"]
        tunits = dec(tvar.attrs.get("units", ""))
        offsets = np.asarray(tvar[()], dtype="f8").reshape(-1)
        epoch = None
        if tunits.startswith("seconds since "):
            epoch = datetime.fromisoformat(tunits[len("seconds since "):].replace("Z", "+00:00").strip())

        fields = {}
        for name, ds in variables.items():
            if name == "time":
                continue
            vdims = dims_of(ds)
            if vdims and vdims[0] == "time":
                fields[name] = (np.asarray(ds[()]), dec(ds.attrs.get("units", "1")), vdims[1:])
    return _assemble(attrs, grid_type, epoch, offsets, fields, device, dtype)


class HDF5Monitor(StateMonitor):
    """Writes the stored states to HDF5: the domain's metadata as file
    attributes, a group ``state_NNNNN`` a state with its ISO time as an
    attribute and a dataset a field (``units`` and JSON ``dims``
    attributes)."""

    def write(self) -> None:
        import h5py

        with h5py.File(self._filename, "w") as f:
            if self._domain is not None:
                for k, v in _domain_attrs(self._domain).items():
                    f.attrs[k] = v
            for idx, snap in enumerate(self._states):
                grp = f.create_group(f"state_{idx:05d}")
                if "time" in snap:
                    grp.attrs["time"] = snap["time"].isoformat()
                for name, payload in snap.items():
                    if name == "time":
                        continue
                    arr, units, dims = payload
                    ds = grp.create_dataset(name, data=arr)
                    ds.attrs["units"] = units
                    ds.attrs["dims"] = json.dumps(list(dims))


def load_hdf5_dataset(filename: str, *, device="cpu", dtype: Optional[torch.dtype] = None):
    """``(domain, "numerical", states)`` from an :class:`HDF5Monitor` file;
    ``device`` and ``dtype`` as in :func:`load_netcdf_dataset`."""
    import h5py

    with h5py.File(filename, "r") as f:
        attrs = dict(f.attrs)
        raw: List[Tuple[Optional[datetime], Dict[str, Any]]] = []
        for key in sorted(k for k in f.keys() if k.startswith("state_")):
            grp = f[key]
            time = datetime.fromisoformat(grp.attrs["time"]) if "time" in grp.attrs else None
            raw.append((time, {
                name: (np.asarray(grp[name]), grp[name].attrs.get("units", "1"),
                       tuple(json.loads(grp[name].attrs.get("dims", "[]"))))
                for name in grp.keys()
            }))
    so, field = _loaded(raw[0][1] if raw else {}, device, dtype)
    domain = _domain_from_attrs(attrs, so) if "nx" in attrs else None
    states = []
    for time, fields in raw:
        state: Dict[str, Any] = {} if time is None else {"time": time}
        state.update({name: field(*entry) for name, entry in fields.items()})
        states.append(state)
    return domain, "numerical", states
