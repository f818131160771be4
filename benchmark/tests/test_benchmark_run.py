"""A run of the harness: without a card it fails and prints no result; on
the CPU, with the look for a card skipped and the cell's own limits, a
sound program comes out correct, and each fault of the timed path that a
forecast can have comes out not correct, as does the control, the
reference in bfloat16 in the program's place."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import check, run, spec
from benchmark.program import Program
from benchmark.reference.model import Reference
from benchmark.tests.conftest import tiny_config

ROOT = Path(__file__).resolve().parents[2]
TRAFFIC = dict(spec.load_json("traffic", "upstream"), checked_forecasts=2)
SECONDS = 0.5
#: long enough that a step left out moves the fields past the cells' limits
STEPS = 30


def test_a_run_without_a_card_fails_and_prints_nothing():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "fc.upstream", "--seed",
                          str(2**31 + 99), "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def limits(config_name):
    """The cell's limits; sus, which has no cell, is held to fc's."""
    return spec.load_json("limits", "fc.upstream")


def measure(config_name, make_program=None, seed=2**31 + 5):
    cfg = tiny_config(config_name, niter=STEPS)
    rec, values, failed = run.measure(f"{config_name}.upstream", cfg, TRAFFIC, limits(config_name), seed, SECONDS,
                                      False, "cpu", make_program)
    bench = spec.load_benchmark(ROOT)
    return run.result(bench, rec, values, limits(config_name), failed, False, "cpu")


def test_a_sound_program_is_correct(config_name):
    out = measure(config_name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) >= {"setup_s", "throughput"}


class Unchanged(Program):
    """A step that returns its state unchanged."""

    def __init__(self, nl, device):
        super().__init__(nl, device)
        self.body.step = lambda fields, hs: dict(fields)


class HalfLeftOut(Program):
    """A step that leaves half the grid (the columns of the eastern half)
    where it was."""

    def __init__(self, nl, device):
        super().__init__(nl, device)
        step = self.body.step

        def half(fields, hs):
            out = step(fields, hs)
            for k, fa in out.items():
                keep = fa.data.clone()
                n = keep.shape[0] // 2
                keep[n:] = fields[k].data[n:]
                out[k] = fa.with_data(keep)
            return out

        self.body.step = half


class Altered(Program):
    """The answer altered where it is produced: one cell of the final water
    vapour raised by a twentieth of its largest value."""

    def outputs(self):
        out = dict(super().outputs())
        qv = out["qv"].clone()
        qv[10, 10, 10] += 0.05 * float(qv.abs().max())
        out["qv"] = qv
        return out


@pytest.mark.parametrize("fault", [Unchanged, HalfLeftOut, Altered], ids=lambda f: f.__name__)
def test_a_fault_of_the_timed_path_is_not_correct(config_name, fault):
    out = measure(config_name, fault)
    assert not out["correct"]
    assert out["failed"] >= 1


class Control(Program):
    """The control: the reference computed in bfloat16 in the program's
    place, handed the same perturbation."""

    def __init__(self, nl, device):
        super().__init__(nl, device)
        self.ref = Reference(nl, device, torch.bfloat16)
        self.steps = nl["niter"]

    def initial(self, pert):
        self.pert = pert
        return super().initial(pert)

    def advance(self, n):
        st = self.ref.forecast(self.ref.initial_state(self.pert["du"], self.pert["dv"], self.pert["rq"]), n)
        self.result = {k: st[k] for k in check.FIELDS}

    def outputs(self):
        return getattr(self, "result", None) or super().outputs()


def test_the_control_is_not_correct(config_name):
    out = measure(config_name, Control)
    assert not out["correct"]
    for k in ("s", "momentum", "water"):  # well past the limit where the reference is float64's
        assert out["checks"][k]["value"] > 3 * out["checks"][k]["limit"]


def test_the_compared_numbers_are_relative_to_the_reference():
    ref = {k: torch.ones(4, 4, 4) for k in check.FIELDS}
    ref["sv"] = torch.full((4, 4, 4), 0.5)
    ref["qv"] = torch.full((4, 4, 4), 2.0)
    ref["accprec"] = torch.zeros(4, 4, 1)
    prog = {k: v.clone() for k, v in ref.items()}
    prog["sv"][0, 0, 0] += 0.01
    prog["qr"][1, 1, 1] += 0.1
    n = check.numbers(prog, ref)
    assert n["s"] == 0.0 and n["momentum"] == pytest.approx(0.01)
    assert n["water"] == pytest.approx(0.05) and n["precipitation"] == 0.0
    prog["accprec"][0, 0, 0] = 1e-3  # mm, where the reference has none: in mm, not a share
    assert check.numbers(prog, ref)["precipitation"] == pytest.approx(1e-3)


@pytest.mark.parametrize("field", check.FIELDS)
def test_a_nan_in_any_field_is_not_correct(field):
    """A NaN in a field that is not the first of its number, or in the
    reference's scale, reads infinite and fails the limits."""
    ref = {k: torch.ones(4, 4, 4) for k in check.FIELDS}
    prog = {k: v.clone() for k, v in ref.items()}
    prog[field][2, 2, 2] = float("nan")
    name = next(n for n, fields in check.COMPARED.items() if field in fields)
    n = check.numbers(prog, ref)
    assert n[name] == float("inf")
    assert not check.within(n, limits("sus"))
    bad_ref = {k: v.clone() for k, v in ref.items()}
    bad_ref[field][1, 1, 1] = float("nan")
    assert check.numbers(ref, bad_ref)[name] == float("inf")


def test_the_result_line_is_strict_json():
    assert run.finite_or_text(float("inf")) == "inf" and run.finite_or_text(1.5) == 1.5
    assert not check.within({k: float("nan") for k in check.COMPARED}, limits("sus"))
    assert check.within({k: 0.0 for k in limits("sus")}, limits("sus"))
    assert not check.within({}, limits("sus"))


def test_a_forecast_perturbation_is_seeded_bounded_and_off_the_boundary():
    from benchmark import traffic

    p = spec.load_json("configs", "fc")["assumed"]["perturbation"]
    a = traffic.perturbation((41, 37, 12), p, 2**31 + 7, 3, "cpu")
    b = traffic.perturbation((41, 37, 12), p, 2**31 + 7, 3, "cpu")
    c = traffic.perturbation((41, 37, 12), p, 2**31 + 7, 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["rq"], c["rq"])
    assert 0.0 < float(a["rq"].abs().max()) <= p["qv_relative"] * (1 + 1e-6) and p["qv_relative"] < 1.0
    assert float(a["du"].abs().max()) <= p["u_m_s"] * (1 + 1e-6)
    e = p["edge_cells"]
    for k in ("du", "dv", "rq"):
        t = a[k]
        assert float(t[:e].abs().max()) == 0.0 and float(t[-e:].abs().max()) == 0.0
        assert float(t[:, :e].abs().max()) == 0.0 and float(t[:, -e:].abs().max()) == 0.0
