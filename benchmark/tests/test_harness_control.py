"""The control comes out not correct on the card: the program with TF32 on
in its float32 matrix products and convolutions, the nearest precision
below the float32 with TF32 off that the configurations state, at each
cell's own size (benchmark/readings.py --control). TF32 exists only on
the card: on the CPU this skips."""
import pytest

CELLS = ["snoopy_sds.e1900", "snoopy_sds.e300"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("TF32, the control's precision, exists only on a CUDA "
                    "card")
    from benchmark import inputs
    from benchmark.readings import readings
    cell = inputs.load_cell(name)
    sound = readings(cell, 7001, "cuda")
    assert all(sound["within"].values()), sound
    control = readings(cell, 7001, "cuda", control=True)
    assert not all(control["within"].values()), control
