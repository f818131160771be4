"""The port's fused loop (``tasmania_tpu_torch/utils/jitx.py``, ``--fused-loop``)
on the CPU, where a CUDA graph cannot run.

* ``carry_read_set`` of the port's SUS step (17x17x8, float64) gives the
  names the JAX ``tasmania_tpu.utils.jitx.carry_read_set`` gives for the JAX
  step, built as ``tests/test_torch_flagship.py`` builds it (``"jax"``
  backend).  By design the port leaves out a field the step returns
  unchanged (the JAX one counts it as read); the SUS step passes no field
  through, so the two sets are equal.
* The graph's body (``StepBody``: the step on static buffers, the mountain
  table indexed by a device counter, the copy-back of the carried fields),
  run eagerly after the traced warm-up step as the drivers run it before
  capture, gives the eager ``run_steps`` result bit for bit over 1 + 3 steps
  for sus, sus with both merges, each other coupling (fc, lfc, ps, sts,
  ssus), sus and fc at third order, sus on the periodic boundary, sus with
  Coriolis and the implicit vertical advection, fc with Coriolis, sus on a
  y-z slice (1x17x8) and over the Schaer mountain (the surface paths of
  ``chip_smoke.py`` phase 13) and the mountain wave.
* The same for both cases of the Burgers driver, whose zhao step takes
  its start time from the body's table.
* ``fused_loop=True`` raises on a CPU device in every driver, and
  ``--fused-loop`` parses in the three command lines.
* ``profile_slice.py --boundary periodic``, eager and under
  ``--fused-loop``, builds the namelist of ``chip_smoke.py``'s
  ``sus_periodic`` (the SUS namelist with ``hb_type="periodic"``,
  ``hb_kwargs={}``), and without the option the namelist's own boundary;
  ``--yz`` and ``--topography schaer`` those of ``sus_yz`` and
  ``sus_schaer``.

The capture and replay themselves run on the card
(``tests/test_torch_kernels.py::test_fused_loop_graph_matches_eager``).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import drivers.namelist_sus as jax_nl
from drivers.driver_namelist_sus import build_domain_and_state, build_model
from tasmania_tpu.framework.field import FieldArray as JaxFieldArray
from tasmania_tpu.framework.options import StorageOptions as JaxStorageOptions
from tasmania_tpu.utils.jitx import carry_read_set as jax_carry_read_set
from tasmania_tpu_torch.drivers import driver_burgers as burgers
from tasmania_tpu_torch.drivers import driver_isentropic_moist as moist
from tasmania_tpu_torch.drivers import driver_mountain_wave as mw
from tasmania_tpu_torch.drivers import driver_namelist_sus as port_driver
from tasmania_tpu_torch.drivers import profile_slice
from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.utils import jitx

SIZE = {"nx": 17, "ny": 17, "nz": 8, "relative_humidity": 1.2}
NSTEPS = 3
CPU64 = StorageOptions(dtype=torch.float64, device="cpu")
MERGES = ("smooth_smag", "vadv_sed")
# the surface paths: coupling and namelist overrides
SURFACE_PATHS = {
    "sus_third": ("sus", {"horizontal_flux_scheme": "third_order_upwind"}),
    "fc_third": ("fc", {"horizontal_flux_scheme": "third_order_upwind"}),
    "sus_periodic": ("sus", {"hb_type": "periodic", "hb_kwargs": {}}),
    "sus_coriolis_implicit": ("sus", {"coriolis_parameter": 1e-4, "implicit_vertical_advection": True}),
    "fc_coriolis": ("fc", {"coriolis_parameter": 1e-4}),
    "sus_yz": ("sus", {"nx": 1, "x_velocity": FieldArray(np.asarray(0.0), "m s^-1", ()),
                       "y_velocity": FieldArray(np.asarray(22.5), "m s^-1", ())}),
    "sus_schaer": ("sus", {"topo_type": "schaer"}),
}
# the mountain wave: 17 x 1 x 20, 1 + 3 steps of 20 s
MW = dict(nx=17, nz=20, hours=4 * 20.0 / 3600.0, dt=20.0)


def test_carry_read_set_matches_jax():
    import jax.numpy as jnp

    values = {k: getattr(jax_nl, k) for k in dir(jax_nl) if not k.startswith("_")}
    values.update(SIZE, backend="jax", so=JaxStorageOptions(dtype=np.float64))
    nl = SimpleNamespace(**values)
    domain, state, pt = build_domain_and_state(nl)
    dycore, physics = build_model(nl, domain, pt)
    names = sorted(k for k in state if k != "time")
    dt_s = nl.timestep.total_seconds()

    def jax_step(fields, hs):
        st = {k: JaxFieldArray(v, state[k].units, state[k].dims) for k, v in fields.items()}
        st["topography_height"] = JaxFieldArray(hs, "m", ("x", "y"))
        st = physics(dycore(st, {}, dt_s), dt_s)
        return {k: st[k].data for k in names}

    hs = jnp.asarray(np.asarray(domain.numerical_grid.topography.steady_profile.to_units("m").data))
    jax_read = jax_carry_read_set(jax_step, {k: jnp.asarray(state[k].data) for k in names}, hs)

    pnl = load_namelist(**SIZE, niter=1, so=CPU64)
    pdomain, pstate, ppt = port_driver.build_domain_and_state(pnl)
    pdycore, pphysics = port_driver.build_model(pnl, pdomain, ppt)
    step = port_driver.fields_step(lambda st, dt: pphysics(pdycore(st, {}, dt), dt), names, dt_s)
    fields = {k: pstate[k] for k in names}
    hs0 = pdycore.topography_steady * 0.0
    out, carried = jitx.traced_step(step, fields, hs0)
    passed_through = {k for k in names if out[k].data is fields[k].data}
    assert passed_through == set()
    assert carried == jax_read - passed_through
    assert jitx.carry_read_set(step, fields, hs0) == carried
    # the prognostics and the recurrences the step reads, of its 17 fields
    assert len(carried) == 10 and len(names) == 17
    assert {"air_isentropic_density", "montgomery_potential", "accumulated_precipitation"} <= carried


def body_steps(step, fields, hs_steady, hs0, facts):
    """The drivers' fused sequence without the graph: the traced warm-up
    step at ``hs0``, then the body run eagerly once for each fact."""
    fields, carried = jitx.traced_step(step, fields, hs0)
    body = jitx.StepBody(step, fields, carried, hs_steady, facts)
    for _ in facts:
        body()
    return body.fields()


def assert_bitwise(got, ref):
    assert set(got) == set(ref)
    for name in sorted(ref):
        assert torch.equal(got[name].data, ref[name].data), name


@pytest.mark.parametrize("path", ["sus", "sus_merged", "fc", "lfc", "ps", "sts", "ssus",
                                  *SURFACE_PATHS])
def test_body_matches_eager_run_steps(path):
    coupling, overrides = SURFACE_PATHS.get(path, ("sus" if path == "sus_merged" else path, {}))
    merges = MERGES if path == "sus_merged" else ()
    nl = moist.load_namelist(coupling, **{**SIZE, **overrides}, niter=NSTEPS, so=CPU64, process_merges=merges)
    ref = moist.run(nl, coupling, verbose=False)["fields"]
    _, state, dycore, step_impl = moist.build_variant(nl, coupling)
    names = sorted(k for k in state if k != "time")
    dt_s = nl.timestep.total_seconds()
    topo_time = nl.topo_kwargs["time"].total_seconds()
    step = port_driver.fields_step(step_impl, names, dt_s)
    facts = [min((i + 1) * dt_s / topo_time, 1.0) for i in range(nl.niter)]
    hs = dycore.topography_steady
    got = body_steps(step, {k: state[k] for k in names}, hs, hs * 0.0, facts)
    assert_bitwise(got, ref)


def test_body_matches_eager_mountain_wave():
    so = StorageOptions(dtype=torch.float64, device="cpu")
    ref = mw.run_case(MW["nx"], MW["nz"], MW["hours"], MW["dt"], so=so, verbose=False)
    _, state, core, diagnostics, pt = mw.build(MW["nx"], MW["nz"], damp_depth=8, so=so)
    names, step = mw.make_step(core, diagnostics, pt, state, MW["dt"])
    hs = core.topography_steady
    nt = ref["steps"]
    # no growth: the whole mountain from the first step, every row of the table
    got = body_steps(step, {k: state[k] for k in names}, hs, 1.0 * hs, [1.0] * (nt - 1))
    assert_bitwise(got, ref["fields"])


@pytest.mark.parametrize("case", burgers.CASES)
def test_body_matches_eager_burgers(case):
    """The Burgers driver at 21x21, 1 + 3 steps: the zhao step reads its
    start time from the body's table (4 ms a step here), from which the
    Dirichlet core computes the frames."""
    ref = burgers.run_case(case, 21, steps=NSTEPS, so=CPU64, verbose=False)["fields"]
    step, fields, starts, _, _ = burgers.make_case(case, 21, 21, 3, NSTEPS, 0, CPU64)
    one = torch.ones((), dtype=torch.float64)
    assert starts[1] == (0.004 if case == "zhao" else 0.0)
    got = body_steps(step, fields, one, starts[0] * one, starts[1:])
    assert_bitwise(got, ref)


def test_step_body_table_counter_and_copy_back():
    """A toy step: the table holds a row a fact and the counter stops at
    its last row; the carried field is copied back, the field returned
    unchanged aliases its input and is not."""
    hs_steady = torch.tensor([[2.0, 4.0]], dtype=torch.float64)
    seen = []

    def step(fields, hs):
        seen.append(hs.clone())
        x = fields["x"].data
        return {"x": fields["x"].with_data(x + hs), "c": fields["c"], "d": fields["d"].with_data(x * 2)}

    fields = {k: FieldArray(torch.ones(1, 2, dtype=torch.float64), "1", ("x", "y"))
              for k in ("x", "c", "d")}
    out, carried = jitx.traced_step(step, fields, hs_steady * 0.0)
    assert carried == {"x"}  # c is read by nobody and returned unchanged, d only written
    facts = [0.25, 0.5, 1.0, 1.0, 1.0]
    body = jitx.StepBody(step, out, carried, hs_steady, facts)
    assert body.table.shape == (5, 1, 2)
    for _ in range(len(facts) + 1):  # one call past the table: its last row again
        body()
    assert [float(h[0, 0]) for h in seen[1:]] == [0.5, 1.0, 2.0, 2.0, 2.0, 2.0]
    assert int(body.counter) == len(facts) + 1
    final = body.fields()
    # x: 1 (warm-up at zero height) + 0.25 + 0.5 + 1 + 1 + 1 + 1 of hs_steady
    assert torch.equal(final["x"].data, torch.tensor([[1.0 + 4.75 * 2.0, 1.0 + 4.75 * 4.0]],
                                                     dtype=torch.float64))
    assert torch.equal(final["c"].data, torch.ones(1, 2, dtype=torch.float64))
    assert body.static["c"].data.data_ptr() == body.out["c"].data.data_ptr()


def test_step_body_refuses_an_output_aliasing_another_input():
    def step(fields, hs):
        return {"a": fields["b"], "b": fields["b"].with_data(fields["b"].data + hs)}

    fields = {k: FieldArray(torch.zeros(2, 2, dtype=torch.float64), "1", ("x", "y")) for k in "ab"}
    body = jitx.StepBody(step, fields, {"b"}, torch.ones(2, 2, dtype=torch.float64), [1.0])
    with pytest.raises(ValueError, match="alias"):
        body()


def test_fused_loop_raises_on_the_cpu():
    nl = load_namelist(**SIZE, niter=1, so=CPU64)
    with pytest.raises(ValueError, match="CUDA"):
        port_driver.run(nl, fused_loop=True)
    with pytest.raises(ValueError, match="CUDA"):
        moist.run(moist.load_namelist("fc", **SIZE, niter=1, so=CPU64), "fc", fused_loop=True)
    with pytest.raises(ValueError, match="CUDA"):
        mw.run_case(MW["nx"], MW["nz"], MW["hours"], MW["dt"], so=CPU64, fused_loop=True)
    domain, state, pt = port_driver.build_domain_and_state(nl)
    dycore, physics = port_driver.build_model(nl, domain, pt)
    with pytest.raises(ValueError, match="CUDA"):
        port_driver.run_steps(nl, state, lambda st, dt: physics(dycore(st, {}, dt), dt),
                              dycore.topography_steady, fused_loop=True)
    hs = dycore.topography_steady
    body = jitx.StepBody(lambda f, h: f, {"x": state["air_isentropic_density"]}, set(), hs, [1.0])
    with pytest.raises(ValueError, match="CUDA"):
        jitx.StepGraph(body)


@pytest.mark.parametrize("main, argv", [
    (port_driver.main, []),
    (moist.main, ["--coupling", "fc"]),
    (mw.main, []),
])
def test_fused_loop_flag_parses(main, argv):
    """Each command line takes ``--fused-loop`` and hands it to its run,
    which refuses the CPU before building anything."""
    with pytest.raises(ValueError, match="CUDA graph"):
        main(argv + ["--nx", "17", "--nz", "8", "--device", "cpu", "--fused-loop"])
    parser = port_driver.size_parser("")
    assert parser.parse_args(["--fused-loop"]).fused_loop
    assert not parser.parse_args([]).fused_loop


def _entries(nl):
    """A namelist's entries by name, as text (some hold arrays)."""
    return {k: repr(v) for k, v in vars(nl).items()}


@pytest.mark.parametrize("argv", [[], ["--fused-loop"]])
def test_profile_slice_boundary_periodic(argv):
    """``--boundary periodic`` gives the profile the namelist of
    ``chip_smoke.py``'s ``sus_periodic``; without it the namelist keeps its
    relaxed boundary; the option refuses the runs that have no namelist."""
    cli = profile_slice.parse(argv + ["--boundary", "periodic"])
    assert cli.fused_loop == bool(argv)
    nl = profile_slice.namelist(cli)
    want = load_namelist(hb_type="periodic", hb_kwargs={})
    assert (nl.hb_type, nl.hb_kwargs) == ("periodic", {})
    assert _entries(nl) == _entries(want)
    plain = profile_slice.namelist(profile_slice.parse(argv))
    assert _entries(plain) == _entries(load_namelist()) and plain.hb_type == "relaxed"
    for other in (["--mountain-wave"], ["--burgers", "bench"]):
        with pytest.raises(SystemExit):
            profile_slice.parse(argv + other + ["--boundary", "periodic"])


@pytest.mark.parametrize("flags, path", [(["--yz"], "sus_yz"), (["--topography", "schaer"], "sus_schaer")])
def test_profile_slice_yz_and_schaer(flags, path):
    """``--yz`` and ``--topography schaer`` give the profile the namelist of
    ``chip_smoke.py``'s ``sus_yz`` and ``sus_schaer`` (the velocities by
    value); both refuse the runs that have no namelist."""
    from chip_smoke import SURFACE_PATHS, namelist_overrides

    nl = profile_slice.namelist(profile_slice.parse(flags))
    want = load_namelist(**namelist_overrides(SURFACE_PATHS[path][1]))
    assert _entries(nl) == _entries(want)
    for name in ("x_velocity", "y_velocity"):
        assert float(np.asarray(getattr(nl, name).data)) == float(np.asarray(getattr(want, name).data))
    assert (nl.nx, nl.topo_type) == ((1, "gaussian") if path == "sus_yz" else (161, "schaer"))
    for other in (["--mountain-wave"], ["--burgers", "bench"]):
        with pytest.raises(SystemExit):
            profile_slice.parse(flags + other)
