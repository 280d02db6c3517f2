"""The block-size helpers copied into the port (``kernels/util.py``) against
the JAX package's: they must agree exactly."""
import pytest

from repro.kernels import util as jutil
from repro_torch.kernels import util as tutil


@pytest.mark.parametrize("n", [1, 2, 7, 12, 37, 97, 256, 1000, 4096, 4099,
                               30030])
def test_block_helpers_match_jax(n):
    for cap in (1, 3, 16, 64, 128, 256, 1024):
        assert tutil.largest_divisor(n, cap) == jutil.largest_divisor(n, cap)
        assert tutil.resolve_block_rows(n, cap) == \
            jutil.resolve_block_rows(n, cap)
