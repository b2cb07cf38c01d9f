"""CastStrings parsing parity: the port's ``ops/cast_strings.py`` STRING ->
number/bool directions against the JAX package's (the formatting
directions are in ``tests/test_torch_cast_format.py``).

The inputs are the vectors of ``tests/test_cast_strings.py`` and
``tests/test_cast_format.py`` plus seeded random strings of the shape
``chip_smoke.numeric_strings`` makes (valid, invalid, signed, fractional,
exponent and whitespace-padded numbers).  Both packages run on the CPU; the
port with ``device="cpu"``.  Tolerance: none — offsets, chars, data bits
and validity are compared bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from spark_rapids_jni_tpu import dtypes as jdt
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.ops import cast_strings as jcs

from spark_rapids_jni_tpu_torch import dtypes as pdt
from spark_rapids_jni_tpu_torch.columnar.interop import (HostColumn,
                                                         column_from_numpy)
from spark_rapids_jni_tpu_torch.ops import cast_strings as pcs

torch.set_num_threads(1)


def to_port(jc):
    return column_from_numpy(HostColumn.of(jc), device="cpu")


def assert_same(jc, pc):
    a, b = HostColumn.of(jc), HostColumn.of(pc)
    assert (a.type_id, a.scale) == (b.type_id, b.scale)
    assert (a.validity is None) == (b.validity is None)
    if a.validity is not None:
        np.testing.assert_array_equal(a.validity, b.validity)
    if a.chars is not None:
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_array_equal(a.chars, b.chars)
    else:
        np.testing.assert_array_equal(
            np.ascontiguousarray(a.data).view(np.uint8),
            np.ascontiguousarray(b.data).view(np.uint8))


VECTORS = [
    "0", "42", "-7", "+13", "  99  ", "2147483647", "123.456", "-1.9", "5.",
    ".5", "", "  ", "abc", "1a", "--5", "+-5", "1e5", "1.5.2", "5 5", None,
    "2147483648", "-2147483648", "-2147483649", "99999999999999999999999",
    "9223372036854775807", "-9223372036854775808", "9223372036854775808",
    "127", "128", "-128", "32767", "32768", "1.5", "-2.25", "1e3", "1.5e-2",
    "+.5", "3.", "1E2", "123.456d", "2f", "inf", "-inf", "Infinity",
    "-INFINITY", "NaN", "nan", "-nan", "1e", "1e+", "1.2.3", "d", "0.25",
    "123456789", "1024", "-0.125", "1e400", "-1e400", "1e-400",
    "1.7976931348623157e308", "3.4e38", "3.4e39", "1.234", "-5.5", "0.001",
    "0.0005", "-0.0005", "0.0015", "1.5e2", "12345e-2", "99999999999.99",
    "1.5f", "0e999", "0.000000000000000000001", "\t7\n", "t", "true", "Y",
    "yes", "1", "f", "FALSE", "n", "no", "0", "maybe", "18446744073709551615",
    "18446744073709551616", "00000000000000000000012", "1.0000000000000000001",
    "-0", "+0.0e-0",
]


def random_strings(seed, n=1500):
    chars, offsets, valid = chip_smoke.numeric_strings(
        np.random.default_rng(seed), n)
    return JColumn.string(chars, offsets, valid)


@pytest.fixture(scope="module", params=["vectors", "random"])
def strings(request):
    if request.param == "vectors":
        return JColumn.from_pylist(VECTORS)
    return random_strings(5)


@pytest.mark.parametrize("target", ["INT8", "INT16", "INT32", "INT64"])
def test_to_integer(strings, target):
    assert_same(jcs.cast_to_integer(strings, getattr(jdt, target)),
                pcs.cast_to_integer(to_port(strings), getattr(pdt, target)))


def java_zero_rows(jc, jout):
    """Rows where the JAX package reads NaN from a number (0 x inf, as in
    "0e999"): Java's parseDouble reads them as a signed zero, and so does
    the port (a kept deviation, ROADMAP queue 3)."""
    strs = jc.to_pylist()
    data = np.asarray(HostColumn.of(jout).data)
    vals = (data.view(np.float64) if data.dtype == np.int64
            else data.astype(np.float64))
    return [i for i, s in enumerate(strs)
            if s is not None and np.isnan(vals[i])
            and "nan" not in s.lower()]


@pytest.mark.parametrize("target", ["FLOAT32", "FLOAT64"])
def test_to_float(strings, target):
    jout = jcs.cast_to_float(strings, getattr(jdt, target))
    pout = pcs.cast_to_float(to_port(strings), getattr(pdt, target))
    zero = java_zero_rows(strings, jout)
    strs = strings.to_pylist()
    got = pout.data.numpy()
    for i in zero:  # Java's value, pinned to Python's float()
        want = np.array(float(strs[i].strip()), got.dtype)
        assert got[i].tobytes() == want.tobytes(), strs[i]
    keep = np.setdiff1d(np.arange(len(strs)), zero)
    assert_same(jout.gather(jnp.asarray(keep)),
                pout.gather(torch.from_numpy(keep)))


@pytest.mark.parametrize("scale", [0, -2, -3, 2])
@pytest.mark.parametrize("width", ["decimal32", "decimal64"])
def test_to_decimal(strings, width, scale):
    assert_same(jcs.cast_to_decimal(strings, getattr(jdt, width)(scale)),
                pcs.cast_to_decimal(to_port(strings),
                                    getattr(pdt, width)(scale)))


def test_to_bool(strings):
    assert_same(jcs.cast_to_bool(strings), pcs.cast_to_bool(to_port(strings)))


@pytest.mark.parametrize("fn,args", [
    ("cast_to_integer", ("INT32",)), ("cast_to_float", ("FLOAT64",)),
    ("cast_to_decimal", ("dec",)), ("cast_to_bool", ())])
def test_ansi_raises_like_jax(fn, args):
    def resolve(mod, a):
        return mod.decimal64(-2) if a == "dec" else getattr(mod, a)
    bad, good = ["1", "nope", None], ["1", None]
    for vals, raises in ((bad, True), (good, False)):
        jc = JColumn.from_pylist(vals)
        outs = []
        for mod, dmod, col in ((jcs, jdt, jc), (pcs, pdt, to_port(jc))):
            call = lambda: getattr(mod, fn)(  # noqa: E731
                col, *[resolve(dmod, a) for a in args], ansi=True)
            if raises:
                with pytest.raises(ValueError):
                    call()
            else:
                outs.append(call())
        if outs:
            assert_same(*outs)


def test_pow10_err_table_bit_exact():
    np.testing.assert_array_equal(
        pcs._POW10_F64_ERR_NP.view(np.int64),
        np.asarray(jcs._POW10_F64_ERR_NP).view(np.int64))
    np.testing.assert_array_equal(pcs._POW10_F64_NP.view(np.int64),
                                  jcs._POW10_F64_NP.view(np.int64))


def test_jax_cpu_takes_the_exact_branch():
    """The JAX search probes its backend; on the CPU it must take the
    on-device branch the port always takes."""
    assert jcs._f64_exact()
