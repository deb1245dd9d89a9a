"""The controls through the harness, at a size a test run holds: a run
with ``control`` judges, in the program's place and by the cell's own
limits, the reference in fp8 (one precision below the configuration's
bf16) or, in training, the reference with half of each batch left out.
Each comes out not correct, and reads well above what the program reads
on the same seed."""
import time

import pytest

from portbench.lib import runner, spec
from portbench.tests.test_portbench_faults import tiny

BENCH = spec.benchmark()
PREFILL = "granite-34b.sealed-prefill"
SHORT = "granite-34b.sealed-prefill-short"
TRAIN = "musicgen-selfattn-2.4b.sealed-train"
S512 = "musicgen-selfattn-2.4b.sealed-train-s512"


def run(cell, seed, control=None):
    cfg, tr = tiny(cell)
    return runner.run_cell(BENCH, cell, seed=seed, seconds=0.3, trace=False,
                           device="cpu", t_start=time.perf_counter(),
                           config=cfg, traffic=tr, control=control)


def value(res, number):
    return res["checks"][number]["value"]


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_prefill_control_reads_far_above_the_program(seed):
    prog, fp8 = run(PREFILL, seed), run(PREFILL, seed, "fp8")
    assert prog["correct"] and not fp8["correct"]
    assert value(fp8, "logits_rel_l2") > 3 * value(prog, "logits_rel_l2")


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_train_control_and_faults_read_far_above_the_program(seed):
    prog = run(TRAIN, seed)
    fp8, half = run(TRAIN, seed, "fp8"), run(TRAIN, seed, "half_batch")
    assert prog["correct"] and not fp8["correct"] and not half["correct"]
    assert value(fp8, "grad_rel_l2") > 3 * value(prog, "grad_rel_l2")
    assert value(half, "loss_gap") > 10 * value(prog, "loss_gap")
    assert value(half, "change_norm_gap") > \
        10 * value(prog, "change_norm_gap")


@pytest.mark.parametrize("cell,control", [
    (PREFILL, "fp8"), (SHORT, "fp8"), (TRAIN, "fp8"), (S512, "fp8"),
    (TRAIN, "half_batch"), (S512, "half_batch")])
def test_the_control_comes_out_not_correct(cell, control):
    res = run(cell, 2**31 + 5, control)
    assert not res["correct"]
    # the program's round trip was sound: the control's own numbers fail
    assert value(res, "roundtrip_mismatches") == 0
    assert any(v["value"] > v["limit"] for v in res["checks"].values())


def test_a_cell_refuses_a_control_it_has_not():
    with pytest.raises(ValueError, match="no control"):
        run(PREFILL, 1, "half_batch")
