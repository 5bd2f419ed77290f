"""Every cell's traffic kind and metric readers, run end to end at tiny
sizes on the CPU (the harness's look for a card skipped), and the readers'
arithmetic on a synthetic trace."""

import json
import math
import re

import pytest

from portbench import harness, readers

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_cpu(cell, trace):
    c = harness.load_cell(cell)
    out = harness.run_cell(c, 2 ** 33 + 17, 0.5, bool(trace), device="cpu",
                           tiny=True)
    line = harness.result_line(out)
    assert out.correct, line["compared"]
    assert out.attempted > 0 and out.failed == 0
    assert list(line)[-1] == "compared"
    names = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    if trace:
        assert set(out.metrics) <= names
        # no device on the CPU: nothing is read from a device trace
        device = {m["name"] for m in c.per_layer
                  if m["source"] == "device_trace"}
        assert not set(out.metrics) & device
    else:
        assert set(out.metrics) == names
    for m in out.metrics.values():
        assert math.isfinite(m["value"]) and m["value"] > 0
    json.dumps(line)


def test_benchmark_files_are_found_by_name():
    for c in BENCH["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert (harness.HERE / "mixes" / f"{w['traffic']}.json").is_file()
        mix = json.loads((harness.HERE / "mixes"
                          / f"{w['traffic']}.json").read_text())
        assert (harness.HERE / "traffic" / f"{mix['kind']}.py").is_file()
        assert (harness.HERE / "limits" / f"{w['name']}.json").is_file()
    for m in BENCH["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
        e2e = {e["name"]: e for e in BENCH["end_to_end"]}
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for entry in (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
                  + BENCH["per_layer"]):
        assert NAME.match(entry["name"])


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        c = harness.load_cell(w["name"])
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer


def _trace():
    k1 = "void attention_fwd_wgmma_kernel<72, false, LengthsMask>(...)"
    ops = [(k1, 1_000, 3_000), ("gemm", 2_500, 6_000),
           ("gemm", 8_000, 9_000)]
    spans = [("window", 0, 10_000), ("batch", 0, 10_000),
             ("to_host", 6_000, 8_000)]
    return harness.Trace(ops, spans, 10e-6)


def test_trace_busy_idle_and_gaps():
    t = _trace()
    assert t.busy_intervals() == [[1_000, 6_000], [8_000, 9_000]]
    assert t.busy_s() == pytest.approx(6e-6)
    gaps = dict(t.breakdown()["idle_gaps"])
    assert gaps["to_host"] == pytest.approx(2e-6)
    assert gaps["batch"] == pytest.approx(2e-6)       # before and after
    assert t.kernel_s("attention_fwd_wgmma_kernel") == pytest.approx(2e-6)


def test_readers_on_a_synthetic_trace():
    tracer = harness.Tracer(True, "cpu")
    tracer.trace = _trace()
    assert readers.idle(tracer) == pytest.approx(40.0)
    assert readers.roofline(tracer, readers.K1, 1e-6) == pytest.approx(50.0)
    assert readers.roofline(tracer, readers.K5, 1e-6) is None   # not there
    tracer.overhead_s = 1.0
    assert readers.mfu({"elapsed": 3.0, "flops": 989e12}, tracer) == \
        pytest.approx(50.0)
