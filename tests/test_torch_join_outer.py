"""The port's outer and cross joins against the JAX package's, on the CPU.

``left_join``, ``right_join``, ``full_join`` and ``cross_join`` over the
tables of tests/test_torch_join.py (null keys, duplicate keys on both
sides, a multi-column key of INT32, STRING with null strings and FLOAT64
with -0.0 and NaN, empty sides), the port with ``device="cpu"``.
Tolerance: bit-exact, rows in JAX's order (the matched pairs in probe
order, then the unmatched rows).
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.ops import join as jjoin
from spark_rapids_jni_tpu_torch.ops import join as pjoin
from test_torch_join import CASES, assert_tables_equal, port_table, sides

torch.set_num_threads(1)
CPU = "cpu"


@pytest.mark.parametrize("kind,nl,nr", CASES)
def test_outer_and_cross_joins_match_jax(kind, nl, nr):
    rng = np.random.default_rng(len(kind) * 1000 + nl + nr + 7)
    left, right, lon, ron = sides(rng, nl, nr, kind)
    pl, pr = port_table(left), port_table(right)
    if nl:  # the JAX outer joins need rows on the probe side
        for name in ("left_join", "right_join", "full_join"):
            assert_tables_equal(getattr(jjoin, name)(left, right, lon, ron),
                                getattr(pjoin, name)(pl, pr, lon, ron,
                                                     device=CPU))
    assert_tables_equal(jjoin.cross_join(left, right),
                        pjoin.cross_join(pl, pr, device=CPU))
