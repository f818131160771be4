"""The mountain-wave driver's ``--sweep`` and ``--diagnose`` in the port
(``tasmania_tpu_torch/drivers/driver_mountain_wave.py``) against the JAX
driver's (``drivers/driver_mountain_wave.py``), on the CPU in float64.

* The sweep at two small cases, 41x1x20 at dt 20 s and 81x1x20 at dt 10 s
  (dx halves; damping depth 8 = max(8, nz // 5), so every window and
  sponge clearance holds points), 60 s (3 and 6 steps), against the JAX
  ``run_case`` at each: the u profiles within 1e-10 of the largest
  magnitude; each case's numbers, computed by the port's ``validation``
  from the JAX run's u, within ``CORR_TOL`` absolute on the correlations
  and ``REL_TOL`` relative on the rest; the JAX row's printed numbers (the
  correlations and the amplitude ratio rounded to 4 places) within half a
  unit of their last place plus ``CORR_TOL``; the convergence order within
  ``REL_TOL`` of the JAX computation on the JAX rows.  Measured on this
  comparison: 2.7e-13 on the correlations, 5.5e-12 relative on the rest,
  so the limits are 1e-10 (a young wave's correlation amplifies the 2e-13
  of the fields).
* ``--diagnose`` at 41x1x20 against the JAX ``diagnose``'s printed lines
  (its ``np.savez`` to a fixed path replaced by a recorder): the case's
  row, the 18 window rows and the localisation, within the same limits
  (measured: 1.3e-12 relative on the rms errors, 0 on the analytic rms);
  the profiles written only when ``out`` is given.
* The default cases and the command line (``--diagnose`` wins over
  ``--sweep``, as in the JAX driver), and the exit without a GPU.
"""

from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import pytest
import torch

import drivers.driver_mountain_wave as jmw
from tasmania_tpu_torch.drivers import driver_mountain_wave as mw
from tasmania_tpu_torch.framework.options import StorageOptions

CASES = ((41, 20, 20.0), (81, 20, 10.0))
HOURS = 60.0 / 3600.0
CPU64 = StorageOptions(dtype=torch.float64, device="cpu")
FIELD_TOL = 1e-10
CORR_TOL = 1e-10
REL_TOL = 1e-10
ROUNDED = 5e-5  # half a unit of the 4th place the JAX driver rounds to
KEYS = ("corr", "corr_focused", "rms_err_focused", "amplitude_ratio", "corr_2a", "corr_3a", "corr_4a",
        "amplitude_ratio_2a", "umax")


def close(got, want, key):
    if key.startswith("corr"):
        return abs(got - want) <= CORR_TOL
    return abs(got - want) <= REL_TOL * abs(want)


@pytest.fixture(scope="module")
def sweep():
    return mw.sweep(CASES, HOURS, so=CPU64, verbose=False)


@pytest.fixture(scope="module")
def jax_rows():
    return [jmw.run_case(nx, nz, HOURS, dt) for nx, nz, dt in CASES]


@pytest.mark.parametrize("i", range(len(CASES)), ids=[f"{nx}x{nz}" for nx, nz, _ in CASES])
def test_sweep_case_matches_jax_run_case(sweep, jax_rows, i):
    got, ref = sweep["results"][i], dict(jax_rows[i])
    u_num, u_an, xs, kd = ref.pop("_fields")
    prof = got["profiles"]
    assert kd == prof["kd"] == 8
    assert np.abs(prof["u_num"] - u_num).max() <= FIELD_TOL * np.abs(u_num).max()
    np.testing.assert_array_equal(prof["xs"], xs)
    np.testing.assert_allclose(prof["u_an"], u_an, rtol=0, atol=1e-14)
    want = mw.validation(np.asarray(u_num, dtype=np.float64), u_an, xs, kd)
    bad = {k: (got[k], want[k]) for k in KEYS if not close(got[k], want[k], k)}
    assert not bad, bad
    for k in ("corr", "corr_focused", "amplitude_ratio"):
        assert abs(got[k] - ref[k]) <= ROUNDED + CORR_TOL, (k, got[k], ref[k])
    assert close(got["rms_err_focused"], ref["rms_err_focused"], "rms_err_focused")
    assert (got["nx"], got["nz"], got["dt"], got["steps"]) == (CASES[i][0], CASES[i][1], CASES[i][2],
                                                                round(HOURS * 3600 / CASES[i][2]))
    assert mw.row(got).keys().isdisjoint(mw.NOT_ROW)


def test_sweep_orders_match_jax(sweep, jax_rows):
    (order,) = sweep["orders"]
    a, b = jax_rows
    want = float(np.log2(a["rms_err_focused"] / b["rms_err_focused"]))
    assert (order["from_nx"], order["to_nx"]) == (41, 81)
    assert abs(order["convergence_order"] - want) <= REL_TOL * max(abs(want), 1.0)
    # printed with the JAX driver's rounding it is the same line
    assert round(order["convergence_order"], 3) == round(want, 3)


def test_sweep_default_cases_are_the_jax_sweeps(monkeypatch, capsys):
    """``SWEEP_CASES`` are the cases the JAX ``main`` runs under
    ``--sweep`` (its ``run_case`` replaced by a recorder)."""
    seen = []

    def record(nx, nz, hours, dt, growth_hours=0.0):
        seen.append((nx, nz, dt))
        return {"nx": nx, "rms_err_focused": 1.0 / nx}

    monkeypatch.setattr(jmw, "run_case", record)
    jmw.main(["--sweep"])
    capsys.readouterr()
    assert tuple(seen) == mw.SWEEP_CASES


@pytest.fixture(scope="module")
def jax_diagnose():
    """The JAX ``diagnose``'s printed lines and what it saved."""
    saved = {}
    real = np.savez
    np.savez = lambda path, **kw: saved.update(path=path, **kw)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            jmw.diagnose(41, 20, HOURS, 20.0)
    finally:
        np.savez = real
    return [json.loads(line) for line in buf.getvalue().splitlines()], saved


@pytest.fixture(scope="module")
def diagnosed():
    return mw.diagnose(41, 20, HOURS, 20.0, so=CPU64, verbose=False)


def test_diagnose_rows_match_jax(jax_diagnose, diagnosed):
    lines, _ = jax_diagnose
    assert len(lines) == 1 + 18 + 1
    assert len(diagnosed["rows"]) == 18
    for got, want in zip(diagnosed["rows"], lines[1:19]):
        assert (got["window_halfwidths"], got["sponge_clearance"]) == (want["window_halfwidths"],
                                                                       want["sponge_clearance"])
        assert abs(got["corr"] - want["corr"]) <= ROUNDED + CORR_TOL, (got, want)
        for k in ("rms_analytic", "rms_error"):
            assert close(got[k], want[k], k), (k, got, want)


def test_diagnose_localisation_and_row_match_jax(jax_diagnose, diagnosed):
    lines, saved = jax_diagnose
    loc, want = diagnosed["localisation"], lines[19]
    assert list(loc) == list(want)
    for k, v in loc.items():
        for g, w in zip(np.atleast_1d(v), np.atleast_1d(want[k])):
            assert close(g, w, k), (k, g, w)
    row = mw.row(diagnosed["result"])
    for k in ("corr", "corr_focused", "amplitude_ratio"):
        assert abs(row[k] - lines[0][k]) <= ROUNDED + CORR_TOL
    assert close(row["rms_err_focused"], lines[0]["rms_err_focused"], "rms_err_focused")
    prof = diagnosed["result"]["profiles"]
    assert np.abs(prof["u_num"] - saved["u_num"]).max() <= FIELD_TOL * np.abs(saved["u_num"]).max()
    assert prof["kd"] == saved["kd"]


def test_diagnose_writes_the_profiles_only_when_asked(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = mw.diagnose(41, 20, 20.0 / 3600.0, 20.0, so=CPU64, verbose=False)
    assert list(tmp_path.iterdir()) == []
    out = tmp_path / "fields.npz"
    mw.diagnose(41, 20, 20.0 / 3600.0, 20.0, so=CPU64, verbose=False, out=str(out))
    assert [p.name for p in tmp_path.iterdir()] == ["fields.npz"]
    with np.load(out) as saved:
        assert sorted(saved.files) == ["kd", "u_an", "u_num", "xs"]
        for k in saved.files:
            np.testing.assert_array_equal(saved[k], res["result"]["profiles"][k])


def test_main_diagnose_wins_over_sweep(capsys):
    tiny = ["--device", "cpu", "--nx", "41", "--nz", "20", "--hours", str(HOURS), "--dtype", "float64"]
    res = mw.main(tiny + ["--sweep", "--diagnose"])
    assert set(res) == {"result", "rows", "localisation"}
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(lines) == 20 and lines[0]["nx"] == 41


def test_main_sweep_runs_the_default_cases(capsys):
    res = mw.main(["--device", "cpu", "--sweep", "--hours", str(20.0 / 3600.0)])
    assert [(r["nx"], r["nz"], r["dt"]) for r in res["results"]] == list(mw.SWEEP_CASES)
    assert [(o["from_nx"], o["to_nx"]) for o in res["orders"]] == [(81, 161), (161, 321)]
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(lines) == 5 and "convergence_order" in lines[-1]


@pytest.mark.parametrize("flag", ["--sweep", "--diagnose"])
def test_tools_default_to_the_card(flag, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as err:
        mw.main([flag])
    assert err.value.code == 2
    assert "no CUDA device is available" in capsys.readouterr().err
