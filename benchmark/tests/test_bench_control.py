"""The control (the reference in TF32 put in the program's place) comes out
as not correct.  TF32 exists on the card alone: on the CPU this skips."""

import pytest

import control


@pytest.mark.parametrize("workload", ["config2.replay"])
def test_control_is_not_correct(tiny, workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("TF32 matrix products exist on a CUDA card only")
    numbers, correct, checked = control.control_run(tiny(workload), 2**31 + 5, 40, "cuda")
    assert correct is False, checked
