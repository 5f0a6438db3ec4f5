"""The graph-threading step with KL (the sub/k-filter) and KM (the
per-pair tail and the read statistics, counting only the pairs that walk
clean) against the JAX make_step(threading=True) on the CPU, over the
grid of tests/test_torch_step_tail.py: -kf {1 1, 2 1, 4 0, 4 4, 5 2} x cth
{1, 20, 200} on the golden and fuzz batches of
tests/test_torch_device_align.py, every output, state key and stat
exact."""

import pytest
import torch

from test_torch_device_align import batches  # noqa: F401
from test_torch_step_tail import KF, check_step, models  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cth", [1, 20, 200])
@pytest.mark.parametrize("nf,nmf", KF)
def test_threading_step_matches_jax(models, batches, nf, nmf,  # noqa: F811
                                    cth):
    check_step(models, batches, nf, nmf, cth, True)
