"""The port's plotting (``tasmania_tpu_torch/plot/``) against the JAX
package's, on the CPU.

* The four golden figures of ``tests/test_plot_golden.py``, drawn through
  the port from a state whose fields are tensors: each within that test's
  ``RMS_TOL`` (5.0 on the 0-255 scale) of ``tests/baseline_images/*.png``,
  and within ``SAME_PROCESS_RMS`` (0.5) of the JAX package's own rendering
  of the same state in this process.
* The cases of ``tests/test_plot.py`` and ``tests/test_plot_properties.py``,
  each parametrised over both packages (``PKGS``): the port's state
  tensor-backed, the JAX package's numpy.
"""

from __future__ import annotations

import os
import tempfile
from datetime import datetime
from pathlib import Path
from types import SimpleNamespace

import matplotlib

matplotlib.use("Agg")

import matplotlib.image as mpimg
import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

import tasmania_tpu.plot as jax_plot
import tasmania_tpu.plot.properties as jax_properties
import tasmania_tpu_torch.plot as port_plot
import tasmania_tpu_torch.plot.properties as port_properties
from tasmania_tpu.domain import Domain as JaxDomain
from tasmania_tpu.framework.field import FieldArray as JaxFieldArray
from tasmania_tpu.isentropic import (
    get_isentropic_state_from_brunt_vaisala_frequency as jax_state_from_bv,
)
from tasmania_tpu_torch.domain.domain import Domain
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.isentropic.state import get_isentropic_state_from_brunt_vaisala_frequency

BASELINE_DIR = Path(__file__).parent / "baseline_images"
RMS_TOL = 5.0  # tests/test_plot_golden.py's limit against the baselines
SAME_PROCESS_RMS = 0.5  # the port's figure against the JAX package's, one process
CPU64 = StorageOptions(dtype=torch.float64, device="cpu")

PKGS = {
    "jax": SimpleNamespace(plot=jax_plot, props=jax_properties, FieldArray=JaxFieldArray,
                           domain=lambda *a, **k: JaxDomain(*a, **k), array=np.asarray,
                           state_from_bv=jax_state_from_bv, kw={}),
    "torch": SimpleNamespace(plot=port_plot, props=port_properties, FieldArray=FieldArray,
                             domain=lambda *a, **k: Domain(*a, **k, storage_options=CPU64),
                             array=lambda a: torch.as_tensor(np.asarray(a)),
                             state_from_bv=get_isentropic_state_from_brunt_vaisala_frequency,
                             kw={"storage_options": CPU64}),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


# --------------------------------------------------------------------------- #
# golden images                                                               #
# --------------------------------------------------------------------------- #


def _golden_setup(p):
    nx, ny, nz = 16, 14, 8
    domain = p.domain((0.0, 1e5), nx, (0.0, 1e5), ny, p.FieldArray(np.array([400.0, 300.0]), "K", ("z",)),
                      nz, horizontal_boundary_type="identity", nb=1)
    x = np.linspace(0, 2 * np.pi, nx)[:, None, None]
    y = np.linspace(0, 2 * np.pi, ny)[None, :, None]
    z = np.linspace(0, 1, nz)[None, None, :]
    fields = {
        "air_isentropic_density": (50.0 + 10.0 * np.sin(x) * np.cos(y) * (1 + z), "kg m^-2 K^-1"),
        "x_momentum_isentropic": (100.0 * np.cos(x) * np.ones_like(y) * np.ones_like(z), "kg m^-1 K^-1 s^-1"),
        "y_momentum_isentropic": (100.0 * np.sin(y) * np.ones_like(x) * np.ones_like(z), "kg m^-1 K^-1 s^-1"),
    }
    state = {"time": datetime(2000, 1, 1)}
    state.update({k: p.FieldArray(p.array(a), u, ("x", "y", "z")) for k, (a, u) in fields.items()})
    return domain.numerical_grid, state


GOLDEN = {
    "contourf_density": (lambda P, g: P.Contourf(g, "air_isentropic_density", "kg m^-2 K^-1", z=slice(5, 6)),
                         {"title": "s", "x_label": "x [m]", "y_label": "y [m]"}),
    "contour_density": (lambda P, g: P.Contour(g, "air_isentropic_density", "kg m^-2 K^-1", z=slice(0, 1)),
                        {"title": "s (top level)"}),
    "quiver_momentum": (lambda P, g: P.Quiver(g, "x_momentum_isentropic", "y_momentum_isentropic",
                                              "kg m^-1 K^-1 s^-1", z=slice(3, 4)),
                        {"title": "momentum"}),
    "profile_density": (lambda P, g: P.LineProfile(g, "air_isentropic_density", "kg m^-2 K^-1",
                                                   x=slice(5, 6), y=slice(5, 6), axis="z"),
                        {"title": "column profile"}),
}


def _render(p, name, path):
    grid, state = _golden_setup(p)
    drawer, axes_properties = GOLDEN[name]
    monitor = p.plot.Plot(drawer(p.plot, grid), interactive=False,
                          figure_properties={"figsize": (6, 4), "dpi": 100},
                          axes_properties=axes_properties)
    fig, _ = monitor.store(state, save_dest=str(path))
    plt.close(fig)
    return mpimg.imread(str(path))


def _rms(a, b):
    assert a.shape == b.shape, f"image size changed: {a.shape} vs {b.shape}"
    return float(np.sqrt(np.mean((255.0 * (a - b)) ** 2)))


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_figure(name, tmp_path):
    port = _render(PKGS["torch"], name, tmp_path / "port.png")
    jax = _render(PKGS["jax"], name, tmp_path / "jax.png")
    baseline = mpimg.imread(str(BASELINE_DIR / f"{name}.png"))
    assert _rms(port, baseline) <= RMS_TOL
    assert _rms(port, jax) <= SAME_PROCESS_RMS


def test_retriever_copies_tensor_to_host():
    grid, state = _golden_setup(PKGS["torch"])
    got = port_plot.DataRetriever(grid, "air_isentropic_density", "g m^-2 K^-1", z=slice(2, 3))(state)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, 1e3 * state["air_isentropic_density"].data.numpy()[:, :, 2])


# --------------------------------------------------------------------------- #
# tests/test_plot.py's cases                                                  #
# --------------------------------------------------------------------------- #


@pytest.fixture(params=sorted(PKGS))
def setup(request):
    p = PKGS[request.param]
    domain = p.domain((0.0, 1e5), 12, (0.0, 1e5), 10, p.FieldArray(np.array([400.0, 300.0]), "K", ("z",)), 6,
                      horizontal_boundary_type="identity", nb=1)
    state = p.state_from_bv(
        domain.numerical_grid, datetime(2000, 1, 1),
        p.FieldArray(np.asarray(10.0), "m s^-1", ()),
        p.FieldArray(np.asarray(3.0), "m s^-1", ()),
        p.FieldArray(np.asarray(0.01), "s^-1", ()),
        **p.kw,
    )
    return p.plot, domain.numerical_grid, state


def test_contourf_plot(setup):
    P, grid, state = setup
    drawer = P.Contourf(grid, "air_isentropic_density", "kg m^-2 K^-1", z=slice(5, 6))
    monitor = P.Plot(drawer, axes_properties={"title": "s", "x_label": "x"})
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "p.png")
        fig, _ = monitor.store(state, save_dest=path)
        plt.close(fig)
        assert os.path.getsize(path) > 1000


def test_contour_and_profile(setup):
    P, grid, state = setup
    c = P.Contour(grid, "montgomery_potential", "m^2 s^-2", z=slice(0, 1))
    lp = P.LineProfile(grid, "air_isentropic_density", "kg m^-2 K^-1", x=slice(5, 6), y=slice(5, 6), axis="z")
    for monitor in (P.Plot(c), P.Plot(lp)):
        plt.close(monitor.store(state)[0])


def test_quiver(setup):
    P, grid, state = setup
    q = P.Quiver(grid, "x_momentum_isentropic", "y_momentum_isentropic", "kg m^-1 K^-1 s^-1", z=slice(3, 4))
    plt.close(P.Plot(q).store(state)[0])


def test_trackers_and_composite(setup):
    P, grid, state = setup
    ts = P.TimeSeries(grid, "air_isentropic_density", "kg m^-2 K^-1", x=slice(5, 6), y=slice(5, 6), z=slice(5, 6))
    hov = P.HovmollerDiagram(grid, "air_isentropic_density", "kg m^-2 K^-1", y=slice(5, 6), z=slice(5, 6),
                             axis="x")
    cdf = P.CDF(grid, "air_isentropic_density", "kg m^-2 K^-1")
    p1, p2, p3 = P.Plot(ts), P.Plot(hov), P.Plot(cdf)
    for _ in range(3):
        plt.close(P.PlotComposite(p1, p2, p3, nrows=1, ncols=3).store([state, state, state])[0])


# --------------------------------------------------------------------------- #
# tests/test_plot_properties.py's cases                                       #
# --------------------------------------------------------------------------- #


@pytest.fixture
def figax():
    fig, ax = plt.subplots()
    yield fig, ax
    plt.close(fig)


def test_titles_labels_limits(pkg, figax):
    fig, ax = figax
    pkg.props.set_axes_properties(ax, {
        "title_left": "L", "title_right": "R", "x_label": "xx", "y_label": "yy",
        "x_lim": (0.0, 2.0), "y_lim": (-1.0, 1.0), "fontsize": 9,
    })
    assert ax.get_title(loc="left") == "L"
    assert ax.get_title(loc="right") == "R"
    assert ax.get_xlabel() == "xx" and ax.get_ylabel() == "yy"
    assert ax.get_xlim() == (0.0, 2.0)
    assert ax.get_ylim() == (-1.0, 1.0)
    assert ax.xaxis.label.get_fontsize() == 9


def test_scales_ticks_formats(pkg, figax):
    fig, ax = figax
    ax.plot([1, 10, 100], [1, 2, 3])
    pkg.props.set_axes_properties(ax, {
        "x_scale": "log", "y_ticks": [1.0, 2.0, 3.0], "y_ticklabels": ["a", "b", "c"],
        "y_ticklabels_rotation": 45.0, "x_tickformat": "%.2f", "invert_yaxis": True,
        "grid_on": True, "grid_properties": {"linestyle": ":"},
    })
    assert ax.get_xscale() == "log"
    assert [t.get_text() for t in ax.get_yticklabels()] == ["a", "b", "c"]
    assert ax.get_yticklabels()[0].get_rotation() == 45.0
    lo, hi = ax.get_ylim()
    assert lo > hi  # inverted


def test_axis_visibility_and_colors(pkg, figax):
    fig, ax = figax
    pkg.props.set_axes_properties(ax, {
        "x_label": "x", "x_labelcolor": "red", "y_ticklabels_color": "blue", "yaxis_visible": False,
    })
    assert ax.xaxis.label.get_color() == "red"
    assert not ax.yaxis.get_visible()


def test_legend_and_text(pkg, figax):
    fig, ax = figax
    ax.plot([0, 1], [0, 1], label="series")
    pkg.props.set_axes_properties(ax, {
        "legend_on": True, "legend_loc": "upper left", "legend_ncol": 2, "text": "note", "text_loc": "lower right",
    })
    assert ax.get_legend() is not None
    assert len(list(ax.artists)) == 1


def test_twin_axes(pkg, figax):
    fig, ax = figax
    pkg.props.set_axes_properties(ax, {"y2_label": "twin-y", "y2_lim": (0.0, 5.0), "x2_ticks": [0.0, 0.5, 1.0]})
    twins = [a for a in fig.get_axes() if a is not ax]
    assert len(twins) == 2
    assert "twin-y" in {a.get_ylabel() for a in twins}


def test_figure_properties(pkg):
    fig, axes = plt.subplots(1, 2)
    try:
        axes[0].plot([0, 1], [0, 1], label="s1")
        pkg.props.set_figure_properties(fig, {
            "suptitle": "SUP", "x_label": "shared-x", "tight_layout": True,
            "subplots_adjust_hspace": 0.4, "figlegend_on": True, "figlegend_loc": "lower center",
        })
        assert fig._suptitle.get_text() == "SUP"
        assert len(fig.legends) == 1
    finally:
        plt.close(fig)


def test_empty_properties_are_noop(pkg, figax):
    fig, ax = figax
    before = (ax.get_title(), ax.get_xlabel(), ax.get_xlim())
    pkg.props.set_axes_properties(ax, None)
    pkg.props.set_figure_properties(fig, {})
    assert (ax.get_title(), ax.get_xlabel(), ax.get_xlim()) == before


def test_unknown_keys_ignored(pkg, figax):
    fig, ax = figax
    pkg.props.set_axes_properties(ax, {"no_such_property": 1, "title": "T"})
    assert ax.get_title() == "T"


def test_monitor_routes_properties(pkg):
    class _Line:
        properties = {}

        def __call__(self, state, fig, ax):
            ax.plot(state["x"], state["y"], label="l")

    mon = pkg.plot.Plot(
        _Line(),
        figure_properties={"figsize": (4, 3), "tight_layout": True},
        axes_properties={"title": "T", "x_label": "X", "grid_on": True},
    )
    fig, ax = mon.store({"x": np.arange(4), "y": np.arange(4)})
    assert ax.get_title() == "T" and ax.get_xlabel() == "X"
    plt.close(fig)


def _tiny_grid(p):
    domain = p.domain((0.0, 1e4), 8, (0.0, 1e4), 6, p.FieldArray(np.array([400.0, 300.0]), "K", ("z",)), 3,
                      horizontal_boundary_type="identity", nb=1)
    return domain.numerical_grid


def _field(p, arr, units):
    return p.FieldArray(p.array(arr), units, ("x", "y", "z"))


def test_lineprofile_flat_keys(pkg, figax):
    fig, ax = figax
    phi = np.arange(8.0 * 6 * 3).reshape(8, 6, 3)
    d = pkg.plot.LineProfile(_tiny_grid(pkg), "phi", "m", y=0, z=0, properties={
        "linecolor": "red", "linestyle": "--", "linewidth": 2.0,
        "legend_label": "prof", "field_factor": 2.0, "field_bias": 1.0,
    })
    d({"phi": _field(pkg, phi, "m")}, fig, ax)
    (line,) = ax.get_lines()
    assert line.get_color() == "red"
    assert line.get_label() == "prof"
    np.testing.assert_allclose(line.get_ydata(), 2.0 * phi[:, 0, 0] + 1.0)


def test_contourf_flat_keys(pkg, figax):
    fig, ax = figax
    rng = np.random.default_rng(0)
    d = pkg.plot.Contourf(_tiny_grid(pkg), "phi", "m", z=0, properties={
        "cmap_name": "viridis", "cbar_levels": 9, "cbar_center": 0.5, "cbar_half_width": 0.5,
        "cbar_orientation": "horizontal", "cbar_title": "phi",
    })
    d({"phi": _field(pkg, rng.uniform(0, 1, (8, 6, 3)), "m")}, fig, ax)
    assert len(fig.get_axes()) == 2  # a colorbar axes was added


def test_quiver_flat_keys(pkg, figax):
    fig, ax = figax
    ones = np.ones((8, 6, 3))
    d = pkg.plot.Quiver(_tiny_grid(pkg), "u", "v", "m s^-1", z=0, properties={
        "x_step": 2, "y_step": 2, "arrow_scale": 10.0, "quiverkey_on": True, "quiverkey_label": "1 m/s",
    })
    d({"u": _field(pkg, ones, "m s^-1"), "v": _field(pkg, ones, "m s^-1")}, fig, ax)


def test_quiver_scalar_coloring_and_cbar(pkg, figax):
    fig, ax = figax
    ones = np.ones((8, 6, 3))
    rng = np.random.default_rng(1)
    state = {"u": _field(pkg, ones, "m s^-1"), "v": _field(pkg, ones, "m s^-1"),
             "T": _field(pkg, rng.uniform(250, 300, (8, 6, 3)), "K")}
    d = pkg.plot.Quiver(_tiny_grid(pkg), "u", "v", "m s^-1", z=0, scalar_field="T", scalar_units="K", properties={
        "scalar_factor": 2.0, "cbar_on": True, "cmap_name": "plasma", "quiverkey_on": True,
        "quiverkey_label": "1 m/s", "quiverkey_fontproperties": {"size": 8},
    })
    d(state, fig, ax)
    assert len(fig.get_axes()) == 2  # colorbar attached


def test_draw_vertical_levels(pkg, figax):
    fig, ax = figax
    rng = np.random.default_rng(0)
    grid = _tiny_grid(pkg)
    d = pkg.plot.Contourf(grid, "phi", "m", y=0, xaxis="x", yaxis="z",
                          properties={"cbar_on": False, "draw_vertical_levels": True})
    d({"phi": _field(pkg, rng.uniform(0, 1, (8, 6, 3)), "m")}, fig, ax)
    assert len(ax.get_lines()) >= len(np.asarray(grid.z_on_interface_levels.data))


def test_patch_flat_keys(pkg, figax):
    fig, ax = figax
    pkg.plot.Circle((0.5, 0.5), 0.2, properties={"edgecolor": "red", "linewidth": 3})({}, fig, ax)
    pkg.plot.Rectangle((0.0, 0.0), 1.0, 0.5, angle=15.0, properties={"facecolor": "blue"})({}, fig, ax)
    pc, pr = ax.patches
    assert pc.get_edgecolor()[0] == 1.0 and pc.get_linewidth() == 3
    assert pr.get_facecolor()[2] == 1.0
    assert pr.angle == 15.0


def test_figure_reference_aliases(pkg):
    fig, _ = plt.subplots()
    try:
        pkg.props.set_figure_properties(fig, {"xlabel": "XX", "ylabel": "YY", "subplots_adjust_vspace": 0.42})
        assert fig.get_supxlabel() == "XX"
        assert fig.get_supylabel() == "YY"
        assert abs(fig.subplotpars.wspace - 0.42) < 1e-12
    finally:
        plt.close(fig)


def test_cbar_ticks_pos(pkg, figax):
    fig, ax = figax
    rng = np.random.default_rng(0)
    d = pkg.plot.Contourf(_tiny_grid(pkg), "phi", "m", z=0, properties={"cbar_ticks_pos": [0.25, 0.5, 0.75]})
    d({"phi": _field(pkg, rng.uniform(0, 1, (8, 6, 3)), "m")}, fig, ax)
    cax = fig.get_axes()[1]
    np.testing.assert_allclose([t for t in cax.get_yticks() if 0 <= t <= 1], [0.25, 0.5, 0.75])
