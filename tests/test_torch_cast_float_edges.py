"""CastStrings float edges: the port against Java's semantics.

Where the JAX package's value is wrong against Java's ``Double.parseDouble``
and ``Double.toString`` (the semantics spark-rapids-jni implements), the
port follows Java.  Python's ``float()`` and ``repr`` are the oracle: both
are correctly rounded, as Java's are.  Each test also asserts the JAX
package's value, so every kept deviation (ROADMAP queue 3) stays visible.

Tolerance: parses within 2 ulp of ``float()`` (the card oracle's); printed
digits must parse back to the same bits; the zero and NaN cases are bit
for bit.  Inputs are seeded.
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import dtypes as jdt
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.ops import cast_strings as jcs

from spark_rapids_jni_tpu_torch import dtypes as pdt
from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.ops import cast_strings as pcs

torch.set_num_threads(1)

NAMED = ["2.2250738585072014e-308", "41451406045246141638E-320",
         "1.5e-320"]


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in units in the last place, over the ordered bit patterns."""
    def ordered(x):
        i = x.view(np.int64 if x.dtype == np.float64 else np.int32) \
            .astype(np.int64)
        mag = np.int64((1 << (8 * x.itemsize - 1)) - 1)
        return np.where(i < 0, -(i & mag), i)
    return np.abs(ordered(a) - ordered(b))


def _deep_strings(seed: int, n: int = 1500) -> list:
    """Decimal strings of values over 1e-330..1e-280: 1-20 digits, plain or
    fractional mantissas, exponents placed so the value lands in range."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        nd = int(rng.integers(1, 21))
        digits = "".join(str(int(d)) for d in rng.integers(0, 10, nd))
        digits = str(int(rng.integers(1, 10))) + digits[1:]
        target = int(rng.integers(-330, -280))
        if rng.random() < 0.5 and nd > 1:
            cut = int(rng.integers(1, nd))
            mant = digits[:cut] + "." + digits[cut:]
            exp = target - cut + 1
        else:
            mant, exp = digits, target - nd + 1
        out.append(f"{mant}{'e' if rng.random() < 0.5 else 'E'}{exp}")
    return out


@pytest.mark.parametrize("target", ["FLOAT64", "FLOAT32"])
def test_parse_below_normal_range_matches_float(target):
    strs = NAMED + _deep_strings(7)
    npdt = np.float64 if target == "FLOAT64" else np.float32
    want = np.array([float(s) for s in strs]).astype(npdt)
    got = pcs.cast_to_float(Column.from_pylist(strs, device="cpu"),
                            getattr(pdt, target)).data.numpy()
    assert got.dtype == npdt
    assert _ulps(got, want).max() <= 2
    if target == "FLOAT64":
        # the JAX package flushes the table power to 0: ±0 for every one
        jv = np.asarray(jcs.cast_to_float(JColumn.from_pylist(NAMED),
                                          jdt.FLOAT64).data).view(np.float64)
        assert (jv == 0.0).all()


def test_parse_float32_subnormals_exact():
    """FLOAT32 subnormals parse exactly in the port; the JAX package flushes
    them to ±0 (a kept deviation)."""
    rng = np.random.default_rng(11)
    vals = np.concatenate([
        10.0 ** rng.uniform(-45, -38.1, 400),
        np.array([1.401298464324817e-45, 1.1754942106924411e-38])])
    strs = [repr(float(np.float32(v))) for v in vals]
    want = np.array([float(s) for s in strs]).astype(np.float32)
    got = pcs.cast_to_float(Column.from_pylist(strs, device="cpu"),
                            pdt.FLOAT32).data.numpy()
    assert _ulps(got, want).max() == 0
    assert (want != 0).all()
    jv = np.asarray(jcs.cast_to_float(JColumn.from_pylist(strs[:50]),
                                      jdt.FLOAT32).data)
    assert (jv[np.abs(want[:50]) < 1e-39] == 0).all()


def test_print_below_1e_268_parses_back():
    rng = np.random.default_rng(13)
    vals = np.concatenate([10.0 ** rng.uniform(-308, -268, 3000),
                           np.array([2.2250738585072014e-308,
                                     6.904451890433193e-285])])
    vals = vals[vals >= np.finfo(np.float64).tiny]
    vals = np.where(rng.random(vals.shape[0]) < 0.3, -vals, vals)
    got = pcs.cast_from_float(Column.fixed(pdt.FLOAT64, vals,
                                           device="cpu")).to_pylist()
    back = np.array([float(s) for s in got])
    assert (back.view(np.int64) == vals.view(np.int64)).all()
    assert [g.lstrip("-") for g in got[-2:]] == \
        ["2.2250738585072014E-308", "6.904451890433193E-285"]
    # the JAX package prints digits of the flushed search
    jv = jcs.cast_from_float(JColumn.from_numpy(
        np.array([2.2250738585072014e-308, 6.904451890433193e-285])))
    assert jv.to_pylist() == ["2.2250738585072015E-308",
                              "6.904451947515319E-285"]


def test_print_then_parse_round_trip():
    rng = np.random.default_rng(17)
    vals = np.concatenate([10.0 ** rng.uniform(-308, -300, 1500),
                           10.0 ** rng.uniform(-324, -308, 300),
                           10.0 ** rng.uniform(-300, 300, 500)])
    vals = vals[vals > 0]
    col = Column.fixed(pdt.FLOAT64, vals, device="cpu")
    back = pcs.cast_to_float(pcs.cast_from_float(col),
                             pdt.FLOAT64).data.numpy()
    assert _ulps(back, vals).max() <= 2


def test_zero_mantissa_reads_zero_and_nan_bits_pinned():
    strs = ["0e999", "-0e999", "0.000e400", "+0E5946470", "nan", "-NaN",
            "1e400", "-1e400"]
    got = pcs.cast_to_float(Column.from_pylist(strs, device="cpu"),
                            pdt.FLOAT64).data.numpy()
    assert got[:4].view(np.int64).tolist() == \
        np.array([0.0, -0.0, 0.0, 0.0]).view(np.int64).tolist()
    jv = np.asarray(jcs.cast_to_float(JColumn.from_pylist(strs),
                                      jdt.FLOAT64).data).view(np.float64)
    assert np.isnan(jv[:4]).all()          # JAX: 0 x inf
    # real NaNs and infinities keep the JAX package's bits
    assert got[4:].view(np.int64).tolist() == jv[4:].view(np.int64).tolist()
