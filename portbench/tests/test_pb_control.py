"""The control, each traffic kind's `Run.control`: the program's int8 path
(ret-embed: w8a8 ViT and LM), the reference in fp8 e4m3 w8a8 for the query
embeddings with the program's int8 corpus scan (ret-search), and the
reference in fp8 e4m3 w8a8 (evisrag-answer), in the program's place. On
the card, at each cell's own size, the harness's comparison finds it out
of the cell's limits where the program is within them; on the CPU, at tiny
sizes, its plumbing runs and departs from the float32 reference further
than the program does."""

import pytest
import torch

from portbench import harness


def _run(cell_name, device, tiny, seconds):
    cell = harness.load_cell(cell_name)
    kind = harness.load_module(harness.HERE / "traffic"
                               / f"{cell.mix['kind']}.py")
    cell.mix = kind.calibration_mix(cell.mix)
    run = kind.Run(cell, 99, torch.device(device), tiny)
    run.warmup()
    run.window(seconds, harness.Tracer(False, device))
    run.release()
    return cell, run


@pytest.mark.parametrize("cell", ["ret-embed", "ret-search",
                                  "evisrag-answer"])
def test_control_departs_from_the_reference_at_tiny_size(cell):
    c, run = _run(cell, "cpu", True, 0.2)
    program = dict(run.check())
    control = run.control()
    assert control
    for name, value in control:
        assert value > max(program[name], 1e-9), (name, value, program)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["ret-embed", "ret-search",
                                  "evisrag-answer"])
def test_control_fails_the_limits_at_the_cells_size(cell, cuda):
    c, run = _run(cell, "cuda", False, 1.0)
    within, compared = harness.judge(run.check(), c.limits)
    assert within, compared
    within, compared = harness.judge(run.control(), c.limits)
    assert not within, compared
