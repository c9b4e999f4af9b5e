"""The comparison finds what it exists to find: a run with a fault planted
under the timed path comes out not correct (``benchmark/faults.py``: an
answer altered where it is produced, half of the batch left out, the RPN's
deltas or objectness wrong), and so does the control, the program's int8
path. The control and the RPN's faults run at the smallest size at which
they depart from the reference as far as they do at the cell's size
(ResNet-101 at 128^2; at 64^2 with the small backbone they lie within the
limits)."""

import pytest

from benchmark import control
from benchmark.faults import FAULTS


RESNET_128 = dict(backbone="resnet101", top_down_pyramid_size=256, fpn_classif_fc_layers_size=1024,
                  image_min_dim=128, image_max_dim=128, mosaic_side=256)
FAULT_SIZE = {"rpn_delta": RESNET_128, "rpn_score": RESNET_128}


def test_a_sound_run_is_correct(run_small):
    assert run_small()["correct"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(run_small, fault):
    with FAULTS[fault]() as factory:
        res = run_small(make_detector=factory, **FAULT_SIZE.get(fault, {}))
    assert not res["correct"]
    assert res["failed"] == 0  # found by the comparison, not by a missing answer


@pytest.mark.parametrize("seed", [7, 8])
def test_the_int8_control_is_not_correct(run_small, seed):
    sound = run_small(seed=seed, seconds=3.0, **RESNET_128)
    assert sound["correct"]
    res = run_small(seed=seed, seconds=3.0, make_detector=control.int8_detector, **RESNET_128)
    assert not res["correct"] and res["failed"] == 0
