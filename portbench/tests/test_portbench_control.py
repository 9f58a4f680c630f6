"""The control of each cell fails its limits, on the card at the cell's own
sizes: the reference put in the program's place and computed with TF32
matmuls, the nearest precision below the configurations' float32 with
TF32 off. Run on a machine with an NVIDIA GPU:

    python -m pytest -p no:cacheprovider portbench/tests/test_portbench_control.py
"""

import pytest
import torch

from portbench import calibrate, harness

SEED = 2 ** 31 + 101
CELLS = {'v2.serve-b8': calibrate.serve_control,
         'dafx22.serve-b8': calibrate.serve_control,
         'v2.train-b6': calibrate.train_control}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "own sizes on the card")
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(CELLS))
def test_control_is_not_correct(cuda_device, name):
    cell = harness.load_cell(name)
    readings = CELLS[name](cell, SEED, cuda_device)
    readings = readings.get('control', readings)
    assert any(value > cell.limits[key] for key, value in readings.items()
               if key in cell.limits), readings
