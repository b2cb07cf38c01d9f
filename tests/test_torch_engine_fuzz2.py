"""Plans 9-16 of the fuzz corpus through the port, against the JAX package
and the fuzzer's pandas oracle: the checks of tests/test_torch_engine_fuzz.py
(plans 1-8), in a file of their own so each file stays short.
"""

import pytest

from test_torch_engine_fuzz import catalog, check_case  # noqa: F401


@pytest.mark.parametrize("case", range(9, 17))
def test_fuzz_plan_matches_jax_and_oracle(catalog, case):  # noqa: F811
    check_case(catalog, case)
