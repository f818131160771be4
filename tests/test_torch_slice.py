"""The port's slice of the moist SUS benchmark against the JAX package.

Three steps of the port's first slice, the chain dycore -> diagnostics ->
smoothing -> velocities (``namelist_sus.slice_skip``), at 17x17x8 in float64: the port on the CPU (through the plain versions of its
kernels) against the JAX driver's ``build_model`` with the same ``skip`` on
the plain ``"jax"`` backend.  Tolerance: every field within 1e-11 of the
field's largest magnitude; the two packages take cumulative sums and
filter sums in different orders, so agreement is to rounding, not bitwise.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import drivers.namelist_sus as jax_nl
from drivers.driver_namelist_sus import build_domain_and_state, build_model
from tasmania_tpu.framework.field import FieldArray as JaxFieldArray
from tasmania_tpu.framework.options import StorageOptions as JaxStorageOptions
from tasmania_tpu_torch.drivers import driver_namelist_sus as port_driver
from tasmania_tpu_torch.drivers.namelist_sus import load_namelist, slice_skip
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.interop import state_to_numpy

SIZE = {"nx": 17, "ny": 17, "nz": 8}
NSTEPS = 3
ROOT = Path(__file__).resolve().parent.parent


def _jax_namelist():
    values = {k: getattr(jax_nl, k) for k in dir(jax_nl) if not k.startswith("_")}
    values.update(SIZE, backend="jax", so=JaxStorageOptions(dtype=np.float64))
    return SimpleNamespace(**values)


def _run_jax():
    import jax.numpy as jnp

    nl = _jax_namelist()
    domain, state, pt = build_domain_and_state(nl)
    dycore, physics = build_model(nl, domain, pt, skip=slice_skip)
    names = sorted(k for k in state if k != "time")
    hs_steady = jnp.asarray(
        np.asarray(domain.numerical_grid.topography.steady_profile.to_units("m").data)
    )
    dt_s = nl.timestep.total_seconds()
    topo_time = nl.topo_kwargs["time"].total_seconds()
    fields = {k: state[k] for k in names}
    initial = {k: np.asarray(v.data) for k, v in fields.items()}
    for i in range(-1, NSTEPS):  # the warm-up step at zero height, then NSTEPS
        fact = 0.0 if i < 0 else min((i + 1) * dt_s / topo_time, 1.0)
        st = dict(fields)
        st["topography_height"] = JaxFieldArray(fact * hs_steady, "m", ("x", "y"))
        st = physics(dycore(st, {}, dt_s), dt_s)
        fields = {k: st[k] for k in names}
    return initial, {k: np.asarray(v.data) for k, v in fields.items()}


def _run_port():
    nl = load_namelist(**SIZE, niter=NSTEPS, so=StorageOptions(dtype=torch.float64, device="cpu"))
    domain, state, pt = port_driver.build_domain_and_state(nl)
    initial = {k: v[0] for k, v in state_to_numpy(state).items() if k != "time"}
    res = port_driver.run(nl, skip=slice_skip, verbose=False)
    return initial, {k: a for k, (a, _) in state_to_numpy(res["fields"]).items()}


@pytest.fixture(scope="module")
def both_runs():
    return _run_jax(), _run_port()


def test_initial_states_agree(both_runs):
    (jax_init, _), (port_init, _) = both_runs
    assert set(jax_init) == set(port_init)
    for name in sorted(jax_init):
        np.testing.assert_array_equal(port_init[name], jax_init[name], err_msg=name)


def test_slice_three_steps_agree(both_runs):
    (_, jax_out), (_, port_out) = both_runs
    assert set(jax_out) == set(port_out)
    for name in sorted(jax_out):
        ref = jax_out[name]
        got = port_out[name]
        assert got.shape == ref.shape, name
        assert np.all(np.isfinite(got)), name
        scale = np.max(np.abs(ref)) or 1.0
        np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=1e-11, err_msg=name)


def test_port_imports_no_jax():
    """Importing the port (the fused loop's ``utils.jitx`` too) and running
    a CPU step of the full flagship chain (the driver's default, with both
    process merges, at third order, with first-order fluxes on the periodic
    boundary and on the Dirichlet one), of each coupling of the variant
    driver (and ssus with both merges, fc at third order), the paths of
    Coriolis and implicit vertical advection (SUS with both, fc with
    Coriolis), SUS on a y-z slice and over the Schaer mountain, importing
    the terrain-following grids, the storage and array utilities and the
    rest of the framework (base components, composite, static checkers,
    offline diagnostics, fakes, validation), importing the physics packages' exports, a forward-Euler
    dycore step, two steps of the mountain-wave driver and two steps
    of each case of the Burgers driver (which import the Burgers model, the
    Dirichlet boundary and the diffusion dwarf), and importing the other
    boundaries and dwarfs, importing ``utils.{iox,checkpoint,timer}`` and
    ``plot``, one checkpointed step of the SUS driver (saved, then
    resumed, with the NaN guard), a step under the backend name ``"jax"``,
    a CPU run of ``driver_profile``, ``driver_dist_bench`` and
    ``driver_weak_scaling`` and of the SUS driver under ``--spmd`` with a
    checkpoint and a resume (their ranks reporting no JAX either), the
    mountain-wave driver's ``--sweep`` and ``--diagnose``, ``bench_variants``
    and one ``driver_roofline`` case, and
    importing every package of the port and resolving each of its
    exports leaves JAX and the JAX package unloaded."""
    code = (
        "import sys, torch\n"
        "import tasmania_tpu_torch.utils.jitx\n"
        "from tasmania_tpu_torch.drivers import driver_isentropic_moist as moist\n"
        "from tasmania_tpu_torch.drivers.driver_namelist_sus import run\n"
        "from tasmania_tpu_torch.drivers.namelist_sus import load_namelist\n"
        "from tasmania_tpu_torch.framework.options import StorageOptions\n"
        "so = StorageOptions(dtype=torch.float32, device='cpu')\n"
        "size = dict(nx=17, ny=17, nz=8, niter=1, so=so)\n"
        "run(load_namelist(**size), verbose=False)\n"
        "merges = ('smooth_smag', 'vadv_sed')\n"
        "run(load_namelist(**size, process_merges=merges), verbose=False)\n"
        "run(load_namelist(**size, horizontal_flux_scheme='third_order_upwind'), verbose=False)\n"
        "for hb in ('periodic', 'dirichlet'):\n"
        "    run(load_namelist(**size, hb_type=hb, hb_kwargs={}, horizontal_flux_scheme='upwind'), verbose=False)\n"
        "moist.run(moist.load_namelist('fc', **size, horizontal_flux_scheme='third_order_upwind'), 'fc', verbose=False)\n"
        "from tasmania_tpu_torch.drivers.driver_namelist_sus import build_domain_and_state\n"
        "from tasmania_tpu_torch.isentropic.dynamics.dycore import IsentropicDynamicalCore\n"
        "domain, state, pt = build_domain_and_state(load_namelist(**size))\n"
        "IsentropicDynamicalCore(domain, moist=True, time_integration_scheme='forward_euler_si',\n"
        "                        storage_options=so)(state, {}, 5.0)\n"
        "for coupling in moist.COUPLINGS:\n"
        "    moist.run(moist.load_namelist(coupling, **size), coupling, verbose=False)\n"
        "moist.run(moist.load_namelist('ssus', **size, process_merges=merges), 'ssus', verbose=False)\n"
        "run(load_namelist(**size, coriolis_parameter=1e-4, implicit_vertical_advection=True), verbose=False)\n"
        "moist.run(moist.load_namelist('fc', **size, coriolis_parameter=1e-4), 'fc', verbose=False)\n"
        "import numpy as np\n"
        "from tasmania_tpu_torch.framework.field import FieldArray\n"
        "wind = {k: FieldArray(np.asarray(v), 'm s^-1', ()) for k, v in (('x_velocity', 0.0), ('y_velocity', 22.5))}\n"
        "run(load_namelist(**{**size, 'nx': 1}, **wind), verbose=False)\n"
        "run(load_namelist(**size, topo_type='schaer'), verbose=False)\n"
        "import tasmania_tpu_torch.domain.grids, tasmania_tpu_torch.utils.storage, tasmania_tpu_torch.utils.array\n"
        "import tasmania_tpu_torch.framework.base_components, tasmania_tpu_torch.framework.composite\n"
        "import tasmania_tpu_torch.framework.static_checkers, tasmania_tpu_torch.framework.offline_diagnostics\n"
        "import tasmania_tpu_torch.framework.fakes, tasmania_tpu_torch.framework.validation\n"
        "import tasmania_tpu_torch.isentropic, tasmania_tpu_torch.isentropic.physics, tasmania_tpu_torch.physics\n"
        "import tasmania_tpu_torch.dwarfs\n"
        "from tasmania_tpu_torch.drivers import driver_mountain_wave as mw\n"
        "mw.run_case(17, 20, 40.0 / 3600.0, 20.0, so=so, verbose=False)\n"
        "import tasmania_tpu_torch.domain.boundaries.periodic, tasmania_tpu_torch.domain.boundaries.identity\n"
        "import tasmania_tpu_torch.dwarfs.horizontal_hyperdiffusion, tasmania_tpu_torch.dwarfs.horizontal_smoothing\n"
        "import tasmania_tpu_torch.isentropic.physics.horizontal_diffusion\n"
        "from tasmania_tpu_torch.drivers import driver_burgers\n"
        "for case in driver_burgers.CASES:\n"
        "    driver_burgers.run_case(case, 16, steps=1, so=so, verbose=False)\n"
        "import tempfile\n"
        "import tasmania_tpu_torch.utils.iox, tasmania_tpu_torch.utils.checkpoint, tasmania_tpu_torch.utils.timer\n"
        "import tasmania_tpu_torch.plot\n"
        "with tempfile.TemporaryDirectory() as ck:\n"
        "    for resume in (False, True):\n"
        "        run(load_namelist(**size), verbose=False, checkpoint_dir=ck, checkpoint_every=1,\n"
        "            resume=resume, nan_guard=True)\n"
        "run(load_namelist(**size, backend='jax'), verbose=False)\n"
        "from tasmania_tpu_torch.drivers import driver_profile, driver_dist_bench, driver_weak_scaling\n"
        "tiny = ['--device', 'cpu', '--nx', '17', '--nz', '8']\n"
        "driver_profile.main(tiny + ['--niter', '1', '--variants', 'full,physics_only'])\n"
        "driver_dist_bench.main(tiny + ['--comm', 'gloo', '--niter', '1'])\n"
        "table = driver_weak_scaling.main(['--device', 'cpu', '--ranks', '1', '--block', '16',\n"
        "                                  '--nz', '8', '--niter', '1', '--analyze'])\n"
        "assert table['rows'][0]['imported_by_rank'] == [[]]\n"
        "hours = ['--hours', str(40.0 / 3600.0)]\n"
        "mw.main(['--device', 'cpu', '--sweep'] + hours)\n"
        "mw.main(['--device', 'cpu', '--nx', '41', '--nz', '20', '--diagnose'] + hours)\n"
        "from tasmania_tpu_torch.drivers import bench_variants, driver_roofline, kernel_timing\n"
        "bench_variants.main(tiny + ['--nt', '1', '--variants', 'sus'])\n"
        "kernel_timing.measure(driver_roofline.build_cases('cpu', 9, 9, 8)[0], 'cpu', 1.0, reps=1)\n"
        "from tasmania_tpu_torch.drivers.driver_namelist_sus import main as sus_main\n"
        "with tempfile.TemporaryDirectory() as ck:\n"
        "    for extra in ([], ['--resume']):\n"
        "        res = sus_main(tiny + ['--niter', '2', '--spmd', '--ranks', '2', '--checkpoint-dir', ck,\n"
        "                               '--checkpoint-every', '1'] + extra)\n"
        "        assert res['imported_by_rank'] == [[], []]\n"
        "import importlib, pkgutil, tasmania_tpu_torch\n"
        "for m in pkgutil.walk_packages(tasmania_tpu_torch.__path__, 'tasmania_tpu_torch.'):\n"
        "    if m.ispkg:\n"
        "        pkg = importlib.import_module(m.name)\n"
        "        [getattr(pkg, n) for n in getattr(pkg, '__all__', ())]\n"
        "[getattr(tasmania_tpu_torch, n) for n in (*tasmania_tpu_torch.SUBPACKAGES, 'FieldArray')]\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'tasmania_tpu.')) or m == 'tasmania_tpu')\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)
