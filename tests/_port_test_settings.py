"""Settings every ``tests/test_torch_*.py`` file imports first.

One torch intra-op thread a process. The suite runs under pytest-xdist with
several workers, and torch's default pool (one thread a core) in every
worker oversubscribes the CPU: the port's tests then slow each other down
and take CPU from the rest of the suite. Each worker imports every test
file while collecting, so this holds before any test runs.
"""

import torch

torch.set_num_threads(1)
