"""The check, driven through a whole run at test size on the CPU (the
harness's look for a chip skipped): sound runs come out correct, and each
fault a cell can have, planted in the timed path underneath, comes out
not correct."""
from __future__ import annotations

import pytest

from portbench import faults, harness
from portbench.reference.precision import FP8

SEED = 2 ** 31 + 12345          # the driver's seeds are this large


def _run(tree, cell, seed=SEED, **kw):
    return harness.run_cell(tree, cell, seed, 0.5, False, "cpu", **kw)


@pytest.mark.parametrize("cell", ["tiny-rwkv6.serve", "tiny-rwkv6.train",
                                  "tiny-deepseek.train"])
def test_sound_runs_are_correct(tiny_tree, cell):
    res = _run(tiny_tree, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell,fault", [
    ("tiny-rwkv6.serve", "altered_token"),
    ("tiny-rwkv6.train", "frozen"),
    ("tiny-rwkv6.train", "half_batch"),
    ("tiny-rwkv6.train", "no_bias_correction"),
    ("tiny-deepseek.train", "frozen"),
    ("tiny-deepseek.train", "half_batch"),
    ("tiny-deepseek.train", "no_bias_correction"),
])
def test_a_planted_fault_is_not_correct(tiny_tree, cell, fault):
    with faults.FAULTS[fault]():
        res = _run(tiny_tree, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell,numbers", [
    ("tiny-rwkv6.serve", ["gap_max"]),
    ("tiny-rwkv6.train", ["loss_gap", "grad_gap", "change_gap"]),
    ("tiny-deepseek.train", ["loss_gap", "grad_gap", "change_gap"]),
])
def test_the_control_is_not_correct(tiny_tree, cell, numbers):
    """The reference in float8, in the program's place, comes out not
    correct under the same limits, and reads at least one number well
    above what the program reads beside it."""
    res = _run(tiny_tree, cell, control=FP8)
    assert not res["correct"], res["checks"]
    r = res["readings"]
    ctl = {n: res["checks"][n]["value"] for n in numbers}
    prog = {n: r[f"program_{n}"] for n in numbers}
    assert any(ctl[n] > 3 * prog[n] and ctl[n] > res["checks"][n]["limit"]
               for n in numbers), (prog, ctl)
