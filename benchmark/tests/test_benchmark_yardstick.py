"""The yardstick's arithmetic on fixed inputs: the byte table against the
port's kernel table in ``PERF.md``, rates, idle and roofline
shares, the whole step's share of the peak, and the reading of a Chrome
trace."""

from __future__ import annotations

import math

import pytest

from benchmark import yardstick
from benchmark.run import Record
from benchmark.spec import reader
from benchmark.tracing import Trace, kind, short_name

UPSTREAM = (161, 161, 120)

#: PERF.md's kernel table, "MB" column, float32 at 161x161x120
TABLE_MB = {
    "si_stage": 336.3, "fused_smoothing": 149.3, "fused_advection_fields": 236.7,
    "fused_momentum_epilogue": 336.2, "fused_kessler_satadj_rk2": 137.1, "fused_smagorinsky_rk2": 62.2,
    "fused_vertical_advection_rk3ws": 161.7, "fused_isentropic_diagnostics": 87.5,
    "fused_sedimentation_rk3ws": 62.3,
}


@pytest.mark.parametrize("op", sorted(TABLE_MB))
def test_byte_table_reproduces_the_kernel_table(op):
    entry = yardstick.load_op(op)
    assert round(yardstick.op_bytes(entry, UPSTREAM, 4, table=True) / 1e6, 1) == TABLE_MB[op]
    # the bound's count is the least a launch moves: never above the table's
    assert yardstick.op_bytes(entry, UPSTREAM, 4) <= yardstick.op_bytes(entry, UPSTREAM, 4, table=True)


def test_bound_of_the_montgomery_mode_and_of_a_sus_step():
    diag = yardstick.load_op("fused_isentropic_diagnostics")
    assert round(yardstick.op_bytes(diag, UPSTREAM, 4) / 1e6, 2) == 24.99  # PERF.md's mtg row
    launches = {"si_stage": 3, "fused_smoothing": 1, "fused_smagorinsky_rk2": 1, "fused_kessler_satadj_rk2": 1,
                "fused_vertical_advection_rk3ws": 1, "fused_sedimentation_rk3ws": 1,
                "fused_isentropic_diagnostics": 1}
    bound, parts = yardstick.step_bound_s(launches, UPSTREAM, 4)
    cell = 161 * 161 * 120 * 4
    si_stage = 3 * (19 * cell + 2 * 162 * 161 * 120 * 4 + 4 * (2 * 161 * 161 + 121)) / 3.35e12
    assert parts["si_stage"] == pytest.approx(si_stage, rel=1e-12)
    assert bound == pytest.approx(sum(parts.values()))
    assert 0.40e-3 < bound < 0.42e-3
    with pytest.raises(KeyError, match="no_such_kernel"):
        yardstick.step_bound_s({"no_such_kernel": 1}, UPSTREAM, 4)


def test_least_step_work_and_step_share():
    least = yardstick.least_step_bytes(UPSTREAM, 4)
    assert round(least / 1e6, 1) == 149.3
    assert yardstick.share_pct(least / yardstick.HBM_BYTES_PER_S, 2.0e-3) == pytest.approx(2.228, abs=1e-3)


def test_union_gaps_and_idle_share():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (9.0, 12.0)]
    assert yardstick.union_s(spans, 0.0, 10.0) == pytest.approx(4.0)
    assert yardstick.gaps(spans, 0.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    assert yardstick.gaps([], 1.0, 2.0) == [(1.0, 2.0)]
    assert yardstick.idle_pct(9.0, 10.0) == pytest.approx(10.0)


def record(**kw):
    rec = Record("fc.upstream", UPSTREAM, 4, 100, **kw)
    return rec


def test_end_to_end_readers():
    rec = record(setup_s=12.5, forecast_s=[0.2] * 9 + [0.3], window_s=2.5, peak_bytes=1_234_000_000)
    assert reader("throughput")(rec) == pytest.approx(math.prod(UPSTREAM) * 100 * 10 / 2.5)
    assert reader("peak_mem_mb")(rec) == pytest.approx(1234.0)
    assert reader("setup_s")(rec) == 12.5


def chrome():
    """A trace of two forecasts of one step each (steps=1): each an init
    kernel, a load copy, a replayed port kernel, a PyTorch kernel and a
    graph copy; times in us."""
    ev = []
    corr = 0
    for f in range(2):
        t = 1000.0 * f
        ev.append({"cat": "user_annotation", "name": "forecast", "ts": t, "dur": 900.0})
        ev.append({"cat": "user_annotation", "name": "forecast.init", "ts": t, "dur": 50.0})
        ev.append({"cat": "user_annotation", "name": "forecast.load", "ts": t + 50, "dur": 50.0})
        ev.append({"cat": "user_annotation", "name": "forecast.replay", "ts": t + 100, "dur": 50.0})
        ev.append({"cat": "user_annotation", "name": "forecast.sync", "ts": t + 150, "dur": 750.0})
        rt = [("cudaLaunchKernel", t + 10), ("cudaMemcpyAsync", t + 60), ("cudaGraphLaunch", t + 110),
              ("cudaDeviceSynchronize", t + 160)]
        ids = []
        for name, ts in rt:
            corr += 1
            ids.append(corr)
            ev.append({"cat": "cuda_runtime", "name": name, "ts": ts, "dur": 5.0 if "Sync" not in name else 800.0,
                       "args": {"correlation": corr}})
        ev.append({"cat": "kernel", "name": "void at::native::normal_kernel<float>(int)", "ts": t + 20, "dur": 10.0,
                   "args": {"correlation": ids[0]}})
        ev.append({"cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)", "ts": t + 70, "dur": 30.0,
                   "args": {"correlation": ids[1]}})
        ev.append({"cat": "kernel", "name": "void (anonymous namespace)::stage_momenta_epilogue<float, 5>(Fields<float>)",
                   "ts": t + 200, "dur": 400.0, "args": {"correlation": ids[2]}})
        ev.append({"cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel<4>(int)",
                   "ts": t + 600, "dur": 100.0, "args": {"correlation": ids[2]}})
        ev.append({"cat": "kernel", "name": "memcpy128", "ts": t + 700, "dur": 50.0, "args": {"correlation": ids[2]}})
    return ev


def test_trace_sorts_operations_by_phase_and_kind():
    tr = Trace(chrome(), steps=1)
    assert tr.forecasts == 2 and tr.steps == 2
    assert tr.window_s == pytest.approx(1900e-6)
    assert tr.seconds("replay", "port") == pytest.approx(800e-6)
    assert tr.seconds("replay", "torch") == pytest.approx(200e-6)
    assert tr.seconds("replay", "copy") == pytest.approx(100e-6)
    assert tr.seconds("load") == pytest.approx(60e-6)
    assert tr.seconds("init") == pytest.approx(20e-6)
    assert tr.count("replay") == 6
    assert tr.busy_s == pytest.approx(2 * (10 + 30 + 550) * 1e-6)
    rec = record(trace=tr, launches={"si_stage": 3})
    assert reader("kernel_ms")(rec) == pytest.approx(0.4)
    assert reader("torch_ms")(rec) == pytest.approx(0.1)
    assert reader("copy_ms")(rec) == pytest.approx(0.05)
    assert reader("load_ms")(rec) == pytest.approx(0.03)
    assert reader("device_ops")(rec) == pytest.approx(3.0)
    assert reader("device_idle_pct")(rec) == pytest.approx(100.0 * (1900 - 1180) / 1900)
    bound, _ = yardstick.step_bound_s({"si_stage": 3}, UPSTREAM, 4)
    assert reader("kernel_roofline_pct")(rec) == pytest.approx(100.0 * bound / 400e-6)
    least = yardstick.least_step_bytes(UPSTREAM, 4) / yardstick.HBM_BYTES_PER_S
    assert reader("step_mfu_pct")(rec) == pytest.approx(100.0 * least / (1900e-6 / 2))
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["port:anon::stage_momenta_epilogue<float, 5>", pytest.approx(800e-6)]
    assert len(bd["idle_gaps"]) <= 10
    longest = bd["idle_gaps"][0]
    assert longest[0] == "forecast.sync/cudaDeviceSynchronize" and longest[1] == pytest.approx(270e-6)


def test_readers_read_nothing_without_a_trace():
    rec = record()
    for name in ("load_ms", "copy_ms", "torch_ms", "device_ops", "kernel_ms", "kernel_roofline_pct",
                 "device_idle_pct", "step_mfu_pct"):
        assert reader(name)(rec) is None


def test_kinds():
    assert kind("kernel", "memcpy128") == "copy" and kind("kernel", "memcpy32_post") == "copy"
    assert kind("gpu_memcpy", "Memcpy DtoD (Device -> Device)") == "copy"
    assert kind("gpu_memset", "Memset (Device)") == "torch"
    assert kind("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)") == "torch"
    assert kind("kernel", "void (anonymous namespace)::diagnostics_kernel<float>(DiagArgs<float>, int)") == "port"
    assert short_name("void (anonymous namespace)::diagnostics_kernel<float>(DiagArgs<float>, int)") == \
        "anon::diagnostics_kernel<float>"
