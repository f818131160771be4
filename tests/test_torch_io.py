"""The port's state I/O (``tasmania_tpu_torch/utils/iox.py``) against the
JAX package's (``tasmania_tpu/utils/iox.py``), on the CPU in float64.

On ``tests/test_io.py``'s setup (12x10x6, relaxed boundary, a Gaussian
mountain), the same state made by each package:

* each package's ``NetCDFMonitor`` and ``HDF5Monitor`` write the same bytes;
* a file written by either package loads through the other's loader with
  equal arrays, units, dims and times, and a domain with equal ``nx, ny,
  nz``, coordinates, boundary type and topography;
* ``tests/test_io.py``'s NetCDF-4 file (HDF5 dimension scales) loads alike
  through both loaders;
* the offline diagnostics of ``tests/test_io.py`` agree on loaded states.

Also: a stored snapshot is a copy (a later in-place change of the state
leaves it as stored), a topography given in km reloads as the same
mountain, and the port's I/O, checkpoint, timer and plot modules import
where neither ``h5py`` nor ``matplotlib`` exists.
"""

from __future__ import annotations

import subprocess
import sys
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from tasmania_tpu.domain import Domain as JaxDomain
from tasmania_tpu.framework.field import FieldArray as JaxFieldArray
from tasmania_tpu.framework.offline_diagnostics import RMSD as JaxRMSD
from tasmania_tpu.framework.offline_diagnostics import RRMSD as JaxRRMSD
from tasmania_tpu.framework.offline_diagnostics import ColumnSum as JaxColumnSum
from tasmania_tpu.isentropic import (
    get_isentropic_state_from_brunt_vaisala_frequency as jax_state_from_bv,
)
from tasmania_tpu.utils import iox as jax_iox
from tasmania_tpu_torch.domain.domain import Domain
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.offline_diagnostics import RMSD, RRMSD, ColumnSum
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.isentropic.state import get_isentropic_state_from_brunt_vaisala_frequency
from tasmania_tpu_torch.utils import iox

ROOT = Path(__file__).resolve().parent.parent
CPU64 = StorageOptions(dtype=torch.float64, device="cpu")
T0 = datetime(2000, 1, 1)
FORMATS = {
    "netcdf": ("NetCDFMonitor", "load_netcdf_dataset", "nc"),
    "hdf5": ("HDF5Monitor", "load_hdf5_dataset", "h5"),
}


def _setup(D, F, state_from_bv, **so):
    domain = D(
        (0.0, 1e5), 12, (0.0, 1e5), 10, F(np.array([400.0, 300.0]), "K", ("z",)), 6,
        horizontal_boundary_type="relaxed", nb=3, horizontal_boundary_kwargs={"nr": 5},
        topography_type="gaussian",
        topography_kwargs={
            "max_height": F(np.asarray(300.0), "m", ()),
            "width_x": F(np.asarray(3e4), "m", ()),
            "width_y": F(np.asarray(3e4), "m", ()),
        },
        **so,
    )
    state = state_from_bv(
        domain.numerical_grid, T0, F(np.asarray(10.0), "m s^-1", ()), F(np.asarray(0.0), "m s^-1", ()),
        F(np.asarray(0.01), "s^-1", ()), **so,
    )
    return domain, state


def _pair():
    """Each package's domain and two states (the second 5 s later, its
    density scaled by 1.01)."""
    out = {}
    for key, D, F, mk, so in (("jax", JaxDomain, JaxFieldArray, jax_state_from_bv, {}),
                              ("torch", Domain, FieldArray, get_isentropic_state_from_brunt_vaisala_frequency,
                               {"storage_options": CPU64})):
        domain, state = _setup(D, F, mk, **so)
        state2 = dict(state)
        state2["time"] = state["time"] + timedelta(seconds=5)
        s = state["air_isentropic_density"]
        state2["air_isentropic_density"] = s.with_data(s.data * 1.01)
        out[key] = (domain, [state, state2])
    return out


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _write(module, monitor, path, domain, states):
    mon = getattr(module, monitor)(str(path), domain)
    for st in states:
        mon.store(st)
    mon.write()


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_states(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        assert g["time"] == r["time"]
        for name in r:
            if name == "time":
                continue
            assert g[name].units == r[name].units, name
            assert tuple(g[name].dims) == tuple(r[name].dims), name
            a, b = _host(g[name].data), _host(r[name].data)
            # a classic NetCDF file is big-endian; the JAX loader keeps that order
            assert a.dtype.newbyteorder("=") == b.dtype.newbyteorder("=") and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def _assert_same_domain(got, ref):
    gp, rp = got.physical_grid, ref.physical_grid
    assert (gp.nx, gp.ny, gp.nz) == (rp.nx, rp.ny, rp.nz)
    for axis in ("x", "y", "z", "z_on_interface_levels", "x_at_u_locations", "y_at_v_locations"):
        np.testing.assert_array_equal(np.asarray(getattr(gp, axis).data), np.asarray(getattr(rp, axis).data))
    assert got.horizontal_boundary.type == ref.horizontal_boundary.type
    assert got.horizontal_boundary.nb == ref.horizontal_boundary.nb
    np.testing.assert_array_equal(np.asarray(got.numerical_grid.topography.steady_profile.data),
                                  np.asarray(ref.numerical_grid.topography.steady_profile.data))


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_monitors_write_the_same_bytes(fmt, pair, tmp_path):
    monitor, _, ext = FORMATS[fmt]
    _write(jax_iox, monitor, tmp_path / f"jax.{ext}", *pair["jax"])
    _write(iox, monitor, tmp_path / f"port.{ext}", *pair["torch"])
    assert (tmp_path / f"jax.{ext}").read_bytes() == (tmp_path / f"port.{ext}").read_bytes()


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_files_load_in_either_package(fmt, writer, pair, tmp_path):
    monitor, loader, ext = FORMATS[fmt]
    path = tmp_path / f"{writer}.{ext}"
    _write(jax_iox if writer == "jax" else iox, monitor, path, *pair[writer])
    port_domain, port_grid_type, port_states = getattr(iox, loader)(str(path))
    jax_domain, jax_grid_type, jax_states = getattr(jax_iox, loader)(str(path))
    assert port_grid_type == jax_grid_type == "numerical"
    assert all(isinstance(v.data, torch.Tensor) and v.data.device.type == "cpu"
               for st in port_states for k, v in st.items() if k != "time")
    _assert_same_states(port_states, jax_states)
    _assert_same_states(port_states, pair["torch"][1])
    _assert_same_domain(port_domain, jax_domain)
    _assert_same_domain(port_domain, pair["torch"][0])


def test_netcdf4_file_loads_alike(tmp_path):
    """``tests/test_io.py::test_netcdf4_h5_interop_load``'s file: a NetCDF-4
    container with HDF5 dimension scales and no domain attributes."""
    import h5py

    rng = np.random.default_rng(0)
    nt, nx, ny, nz = 2, 5, 4, 3
    u = rng.normal(size=(nt, nx, ny, nz)).astype("f8")
    s = rng.normal(size=(nt, nx, ny, nz)).astype("f8") + 100.0
    path = tmp_path / "ref_style.nc"
    with h5py.File(path, "w") as f:
        f.attrs["_NCProperties"] = np.bytes_(b"version=2,netcdf=4.9.0")
        f.attrs["grid_type"] = "numerical"
        tvar = f.create_dataset("time", data=np.array([0.0, 30.0], dtype="f8"))
        tvar.attrs["units"] = np.bytes_(b"seconds since 2000-01-01T00:00:00")
        tvar.make_scale("time")
        dims = {}
        for dname, size in (("x", nx), ("y", ny), ("z", nz)):
            d = f.create_dataset(dname, data=np.arange(size, dtype="f8"))
            d.make_scale(dname)
            dims[dname] = d
        for name, arr, units in (("x_velocity", u, b"m s^-1"), ("air_isentropic_density", s, b"kg m^-2 K^-1")):
            v = f.create_dataset(name, data=arr)
            v.attrs["units"] = np.bytes_(units)
            v.dims[0].attach_scale(tvar)
            for ax, dname in enumerate(("x", "y", "z")):
                v.dims[1 + ax].attach_scale(dims[dname])

    domain, grid_type, states = iox.load_netcdf_dataset(str(path))
    jax_domain, jax_grid_type, jax_states = jax_iox.load_netcdf_dataset(str(path))
    assert domain is None and jax_domain is None
    assert grid_type == jax_grid_type == "numerical"
    _assert_same_states(states, jax_states)
    assert states[1]["time"] == datetime(2000, 1, 1, 0, 0, 30)
    assert states[1]["x_velocity"].dims == ("x", "y", "z")
    np.testing.assert_array_equal(states[1]["x_velocity"].data.numpy(), u[1])


def test_offline_diagnostics_on_loaded_states(pair, tmp_path):
    """``tests/test_io.py::test_offline_diagnostics``'s metrics, on the two
    states as each package loads them back from the JAX package's file."""
    path = tmp_path / "jax.nc"
    _write(jax_iox, "NetCDFMonitor", path, *pair["jax"])
    domain, _, (a, b) = iox.load_netcdf_dataset(str(path))
    jdomain, _, (ja, jb) = jax_iox.load_netcdf_dataset(str(path))
    fields = {"air_isentropic_density": {"units": "kg m^-2 K^-1"}}
    for port_cls, jax_cls in ((RMSD, JaxRMSD), (RRMSD, JaxRRMSD)):
        got = port_cls(domain.numerical_grid, fields)(a, b)
        ref = jax_cls(jdomain.numerical_grid, fields)(ja, jb)
        assert got == pytest.approx(ref, rel=1e-14, abs=0.0)
    got = ColumnSum(domain.numerical_grid, "air_isentropic_density", "kg m^-2 K^-1")(b)
    ref = JaxColumnSum(jdomain.numerical_grid, "air_isentropic_density", "kg m^-2 K^-1")(jb)
    assert got.shape == (12, 10)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-14, atol=0.0)


def test_store_takes_a_copy(tmp_path):
    domain, state = _setup(Domain, FieldArray, get_isentropic_state_from_brunt_vaisala_frequency,
                                storage_options=CPU64)
    before = state["air_isentropic_density"].data.clone()
    mon = iox.NetCDFMonitor(str(tmp_path / "c.nc"), domain)
    mon.store(state)
    state["air_isentropic_density"].data.mul_(2.0)
    mon.write()
    _, _, (loaded,) = iox.load_netcdf_dataset(str(tmp_path / "c.nc"))
    assert torch.equal(loaded["air_isentropic_density"].data, before)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_topography_in_km_reloads_as_the_same_mountain(dtype, tmp_path):
    """The flagship gives its mountain in km; the port writes it in the
    metres its loader reads, so the rebuilt topography is the original's,
    and the domain takes the stored fields' dtype."""
    so = StorageOptions(dtype=dtype, device="cpu")
    km = {k: FieldArray(np.asarray(v), "km", ()) for k, v in (("max_height", 0.5), ("width_x", 50.0),
                                                              ("width_y", 50.0))}
    domain = Domain((-176e3, 176e3), 21, (-176e3, 176e3), 21, FieldArray(np.array([400.0, 280.0]), "K", ("z",)),
                    8, horizontal_boundary_type="relaxed", nb=3, horizontal_boundary_kwargs={"nr": 6},
                    topography_type="gaussian", topography_kwargs={"time": timedelta(seconds=1800), **km},
                    storage_options=so)
    state = {"time": T0, "air_isentropic_density": FieldArray(torch.ones((27, 27, 8), dtype=dtype), "kg m^-2 K^-1")}
    mon = iox.NetCDFMonitor(str(tmp_path / "km.nc"), domain)
    mon.store(state)
    mon.write()
    loaded, _, (st,) = iox.load_netcdf_dataset(str(tmp_path / "km.nc"))
    assert st["air_isentropic_density"].data.dtype == dtype
    assert loaded.physical_grid.topography.time == timedelta(seconds=1800)
    assert loaded.horizontal_boundary.kwargs["nr"] == 6
    _assert_same_domain(loaded, domain)


def test_imports_without_h5py_or_matplotlib():
    """The card's Python has neither package: the port's I/O, checkpoint,
    timer and plot modules import all the same, and the NetCDF round trip
    runs through scipy alone."""
    code = (
        "import sys, tempfile, os\n"
        "sys.modules['h5py'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "import torch, numpy as np\n"
        "import tasmania_tpu_torch.plot\n"
        "import tasmania_tpu_torch.utils.checkpoint, tasmania_tpu_torch.utils.timer\n"
        "from tasmania_tpu_torch.utils import iox\n"
        "from tasmania_tpu_torch.framework.field import FieldArray\n"
        "path = os.path.join(tempfile.mkdtemp(), 's.nc')\n"
        "mon = iox.NetCDFMonitor(path)\n"
        "mon.store({'air_isentropic_density': FieldArray(torch.arange(24.0).reshape(2, 3, 4), 'kg m^-2 K^-1')})\n"
        "mon.write()\n"
        "_, _, (st,) = iox.load_netcdf_dataset(path)\n"
        "assert torch.equal(st['air_isentropic_density'].data, torch.arange(24.0).reshape(2, 3, 4))\n"
        "try:\n"
        "    iox.HDF5Monitor(path).write()\n"
        "except ImportError:\n"
        "    pass\n"
        "else:\n"
        "    raise AssertionError('h5py was found')\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
