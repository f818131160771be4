"""The port's bench tools on the CPU: ``bench_variants``, ``bench_kernels``,
``driver_roofline`` and their shared harness ``kernel_timing``.

* ``bench_variants`` at 17x17x8 with ``nt = 2``: a row for each of the six
  couplings whose umax and vmax (and every field) equal
  ``driver_isentropic_moist.run`` at the same namelist bit for bit (the
  warm-up step and ``nt`` steps from the initial state).
* The unique bytes of every ``driver_roofline`` case and of both
  ``bench_kernels`` cases against the JAX drivers' ``_bytes`` rule: the
  JAX roofline's own ``build_cases`` at 9x9x8 (its module's grid set small),
  and ``_bytes`` on arrays of the JAX ``bench_kernels`` shapes.
* The harness: the L2 copies taken in turn, the copy rate's buffer, a CPU
  run of both tools, and each new entry point exiting without a GPU
  unless ``--device cpu`` is given.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

import drivers.driver_roofline as jroof
from tasmania_tpu_torch.drivers import bench_kernels as bk
from tasmania_tpu_torch.drivers import bench_variants as bvar
from tasmania_tpu_torch.drivers import driver_isentropic_moist as moist
from tasmania_tpu_torch.drivers import driver_roofline as roof
from tasmania_tpu_torch.drivers import kernel_timing as kt
from tasmania_tpu_torch.framework.options import StorageOptions

SIZE = dict(nx=17, ny=17, nz=8)
NT = 2
SMALL = (9, 9, 8)
JAX_CASES = ("advection_fields(4f,q_product,bc)", "momentum_epilogue(6f out)", "diagnostics(moist,MXU scans)",
             "si_stage(whole stage, 6f out)", "montgomery(per-stage scan)", "vertical_advection_rk3ws(6f)",
             "smoothing(6f,order2)", "sedimentation_rk3ws", "smagorinsky_rk2(2 stages)", "kessler_rk2",
             "satadj_rk2")


@pytest.fixture(scope="module")
def bench():
    return bvar.bench_variants(bvar.VARIANTS, NT, device="cpu", verbose=False, **SIZE)


@pytest.mark.parametrize("coupling", bvar.VARIANTS)
def test_bench_variants_row_is_the_drivers_run(bench, coupling):
    row = bench["rows"][coupling]
    so = StorageOptions(dtype=moist.load_namelist(coupling).so.dtype, device="cpu")
    ref = moist.run(moist.load_namelist(coupling, niter=NT, so=so, **SIZE), coupling, verbose=False)
    assert (row["umax"], row["vmax"]) == (ref["umax"], ref["vmax"])
    got = bench["fields"][coupling]
    assert set(got) == set(ref["fields"])
    unequal = [k for k, fa in ref["fields"].items() if not torch.equal(got[k].data, fa.data)]
    assert not unequal, unequal
    assert len(row["ms_per_step_runs"]) == bvar.MIN_PAIRS
    assert row["ms_per_step_range"][0] <= row["ms_per_step"] <= row["ms_per_step_range"][1]
    assert row["gridpoints_per_s"] == pytest.approx(17 * 17 * 8 / (row["ms_per_step"] * 1e-3))
    assert row["launches_per_step"] == {} and not row["graph"] and row["build_capture_s"] > 0.0


def test_bench_variants_refuses_unknown_couplings():
    with pytest.raises(ValueError, match="unknown coupling"):
        bvar.bench_variants(("xx",), 1, device="cpu", **SIZE)


def test_bench_variants_writes_its_table(tmp_path, capsys):
    out = tmp_path / "variants.json"
    bvar.main(["--device", "cpu", "--nx", "17", "--nz", "8", "--nt", "1", "--variants", "sus", "--out",
               str(out)])
    table = json.loads(out.read_text())
    assert list(table["variants"]) == ["sus"] and table["device"] == "cpu"
    assert "coupling-variant bench on cpu" in capsys.readouterr().out


@pytest.fixture(scope="module")
def jax_cases():
    """The JAX roofline's cases at 9x9x8: name -> unique bytes."""
    saved = (jroof.NX, jroof.NY, jroof.NZ)
    jroof.NX, jroof.NY, jroof.NZ = SMALL
    try:
        cases, _ = jroof.build_cases()
    finally:
        jroof.NX, jroof.NY, jroof.NZ = saved
    return {name: nbytes for name, (_, _, nbytes) in cases.items()}


@pytest.fixture(scope="module")
def port_cases():
    return {c.jax_case: c for c in roof.build_cases("cpu", *SMALL)}


def test_roofline_has_the_jax_cases(jax_cases, port_cases):
    assert set(port_cases) == set(jax_cases) == set(JAX_CASES)
    assert sorted({c.number for c in port_cases.values()}) == [1, 3, 5, 7, 8, 10, 12, 14, 16, 17]


@pytest.mark.parametrize("name", JAX_CASES)
def test_roofline_bytes_follow_the_jax_rule(jax_cases, port_cases, name):
    assert port_cases[name].bytes == jax_cases[name]


def _jax_bench_kernels_bytes(nx, nz):
    """``_bytes`` of the JAX ``bench_kernels`` arrays (``:64-69``) for its
    advection, and of the momentum step's ten inputs with its two outputs."""
    f32 = np.float32
    u, v = np.zeros((nx + 1, nx, nz), f32), np.zeros((nx, nx + 1, nz), f32)
    s = np.zeros((nx, nx, nz), f32)
    qs = [np.zeros_like(s) for _ in range(3)]
    mom = [np.zeros_like(s) for _ in range(7)]
    return {"fused_advection_fields": jroof._bytes(u, v, s, *qs) + 4 * s.nbytes,
            "fused_momentum_step": jroof._bytes(u, v, s, *mom) + 2 * s.nbytes}


@pytest.mark.parametrize("kernel", ["fused_advection_fields", "fused_momentum_step"])
def test_bench_kernels_bytes_follow_the_jax_rule(kernel):
    cases = {c.kernel: c for c in bk.build_cases("cpu", 9, 8)}
    assert cases[kernel].bytes == _jax_bench_kernels_bytes(9, 8)[kernel]


def test_roofline_and_bench_kernels_run_on_the_cpu():
    table = roof.roofline("cpu", *SMALL, reps=1)
    assert len(table["rows"]) == 11
    assert table["worst"] in {r["name"] for r in table["rows"]}
    for r in table["rows"]:
        assert r["timed_by"] == "host clock" and r["copies"] == 1 and not r["fault"]
        assert r["calls"] == 1 + 3 and r["launches"] == 0  # warm-up and reps; no kernel on the CPU
        assert math.isfinite(r["gbs"]) and r["ms"] > 0.0
    json.dumps(table)
    rows = bk.bench("cpu", 9, 8, reps=1)["rows"]
    assert [r["kernel"] for r in rows] == ["fused_advection_fields", "fused_momentum_step"]


def test_copy_rate_buffer_and_median():
    c = kt.copy_rate((4, 3, 2), "cpu")
    assert c["shape"] == [kt.COPY_FACTOR * 4, 3, 2]
    assert c["bytes_read"] == c["bytes_written"] == kt.COPY_FACTOR * 4 * 3 * 2 * 4
    assert len(c["runs"]) == kt.COPY_RUNS and c["spread"][0] <= c["gbs"] <= c["spread"][1]
    assert c["above_spec"] == []  # only a card's reading is held to the data sheet


def test_measure_calls_copies_in_turn_below_twice_the_l2(monkeypatch):
    """A case whose working set fits in twice the L2 is called on enough
    copies of its inputs to fill it, each in turn."""
    x = torch.ones(10)
    seen = []
    case = kt.Case("double", "none", 0, "none", {"x": x}, lambda a: seen.append(a["x"]) or 2 * a["x"],
                   3 * x.numel() * 4)
    working = 2 * x.numel() * 4
    monkeypatch.setattr(kt, "l2_bytes", lambda device: 3 * working)
    row = kt.measure(case, "cpu", copy_gbs=1.0, reps=4)
    assert row["copies"] == 6 and row["working_set_bytes"] == working
    timed = seen[1:]
    assert len(timed) == row["calls"] == 3 + 4
    assert len({id(t) for t in timed[:6]}) == 6 and timed[6] is timed[0]
    assert all(torch.equal(t, x) for t in timed)


def test_measure_refuses_non_finite_outputs():
    case = kt.Case("nan", "none", 0, "none", {"x": torch.ones(3)}, lambda a: a["x"] / 0.0 * 0.0, 24)
    with pytest.raises(AssertionError, match="not finite"):
        kt.measure(case, "cpu", copy_gbs=1.0, reps=1)


def test_bench_kernels_says_tiles_are_not_ported(capsys):
    with pytest.raises(SystemExit) as err:
        bk.main(["--help"])
    assert err.value.code == 0
    assert "--tiles" in capsys.readouterr().out


@pytest.mark.parametrize("main", [bvar.main, bk.main, roof.main], ids=["bench_variants", "bench_kernels",
                                                                       "driver_roofline"])
def test_entry_points_default_to_the_card(main, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as err:
        main([])
    assert err.value.code == 2
    assert "no CUDA device is available" in capsys.readouterr().err
