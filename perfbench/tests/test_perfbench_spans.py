"""``tools/spans.py``: the program's spans read from a handmade Chrome trace
beside the harness's spans, the fused kernel's bound, and a tiny run of each
cell's loop on the CPU."""

import json

import pytest

from perfbench.harness import spec
from perfbench.tests import tiny
from perfbench.tools import spans
from perfbench.yardstick import trace as trace_reader

BENCH = spec.benchmark()


def _x(name, ts, dur, cat, **args):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}
    if args:
        e["args"] = args
    return e


def _trace(tmp_path, nested: bool):
    """One stretch [0, 1000] us: ``perfbench.vag`` [90, 420] holding, when
    ``nested``, ``vag.kernel`` [150, 330]; three kernels launched at 160 (in
    both spans), 350 (in ``perfbench.vag`` alone) and 500 (in neither)."""
    events = [_x(trace_reader.STRETCH, 0, 1000, "user_annotation"),
              _x("perfbench.vag", 90, 330, "user_annotation"),
              _x("cudaLaunchKernel", 160, 5, "cuda_runtime", correlation=1),
              _x("cudaLaunchKernel", 350, 5, "cuda_runtime", correlation=2),
              _x("cudaLaunchKernel", 500, 5, "cuda_runtime", correlation=3),
              _x("k1", 200, 60, "kernel", correlation=1),
              _x("k2", 360, 40, "kernel", correlation=2),
              _x("k3", 520, 80, "kernel", correlation=3)]
    if nested:
        events.append(_x("vag.kernel", 150, 180, "user_annotation"))
    path = tmp_path / f"trace{int(nested)}.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_a_kernel_counts_for_every_span_that_holds_its_launch(tmp_path):
    got = spans.read_spans(_trace(tmp_path, nested=True), ("perfbench.vag", "vag.kernel"))
    assert got["spans"]["perfbench.vag"]["device_s"] == pytest.approx(100e-6)
    assert got["spans"]["vag.kernel"]["device_s"] == pytest.approx(60e-6)
    assert got["kernel_s"] == pytest.approx(180e-6)
    # idle gaps [0, 200], [260, 360], [400, 520], [600, 1000]: middles 100,
    # 310, 460, 800; 310 lies in both spans
    assert got["idle_s"] == pytest.approx(820e-6)
    assert got["spans"]["vag.kernel"]["idle_s"] == pytest.approx(100e-6)
    assert got["spans"]["perfbench.vag"]["idle_s"] == pytest.approx(300e-6)
    assert got["spans"]["vag.kernel"]["calls"] == 1


def test_nested_program_spans_leave_the_harness_reader_as_it_was(tmp_path):
    names = ("perfbench.vag", "perfbench.grad")
    before = trace_reader.summarize(_trace(tmp_path, nested=False), names)
    after = trace_reader.summarize(_trace(tmp_path, nested=True), names)
    assert after.span_device_s == before.span_device_s
    assert after.span_calls == before.span_calls
    assert after.span_device_s["perfbench.vag"] == pytest.approx(100e-6)
    # the gap whose middle lies in the program's span takes its name
    assert dict(after.idle_gaps)["vag.kernel"] == pytest.approx(100e-6)
    assert "vag.kernel" not in dict(before.idle_gaps)


def test_kernel_bound_at_bench_shape():
    # chip_smoke.py phase 3: 0.2438 ms by operations (the bytes need 0.0312 ms)
    assert spans.kernel_bound_s(60000, 784, 10, 128) * 1e3 == pytest.approx(0.2438, abs=1e-4)
    # one chain: bound by the bytes, X in bf16 (94.08 MB) and the rest in f32
    moved = 2 * 60000 * 784 + 4 * (60000 * 10 + 2 * 784 * 10 + 2 * 10 + 1)
    assert spans.kernel_bound_s(60000, 784, 10, 1) == pytest.approx(moved / 3.35e12)


@pytest.mark.parametrize("cell_name", [w["name"] for w in BENCH["workloads"]])
def test_tiny_run_on_the_cpu(cell_name):
    line = spans.measure(cell_name, 2 ** 32 + 5, pairs=2, device="cpu",
                         overrides=tiny.overrides(BENCH, cell_name))
    assert json.loads(json.dumps(line)) == line
    assert line["correct"] is True
    loop = spec.traffic(spec.cell(cell_name, BENCH)["traffic"])["loop"]
    got = {k for k, v in line["readings"].items() if v is not None}
    # the CPU trace has no device events: only the host readings can print
    assert got == ({"nuts.host_ms_per_leaf", "nuts.flag_wait_share"} if loop == "nuts"
                   else set())
    assert set(line["host"]) == set(spans.SGHMC if loop == "sghmc" else
                                    spans.VAG + (spans.NUTS if loop == "nuts" else ()))
    if loop == "nuts":
        assert line["host"]["nuts.leaf"]["calls"] == line["leaves_rise"] > 0
        assert 0.0 < line["readings"]["nuts.flag_wait_share"] < 100.0
    if loop == "sghmc":
        steps = line["host"]["sghmc.batch"]["calls"]
        assert line["host"]["sghmc.update"]["calls"] == 2 * steps
    assert line["stretch"]["spans"]        # the program's spans reached the trace
