"""Few threads a test process: the toy runs are small, and several pytest
workers share the machine's cores."""

import torch

torch.set_num_threads(2)
