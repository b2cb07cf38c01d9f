"""String op parity: the port's ``ops/strings.py``, ``ops/regex_rewrite.py``
and ``ops/dictionary.py`` against the JAX package's.

Inputs: the literal vectors of ``tests/test_strings.py`` style (multi-byte
UTF-8, empty strings, nulls, delimiters at the ends) and seeded NDS-shaped
text from ``chip_smoke.text_strings``.  Both packages run on the CPU (the
port with ``device="cpu"``).  Tolerance: none — offsets, chars, data and
validity compared bit for bit; LIST columns by offsets and child.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.ops import dictionary as jdict
from spark_rapids_jni_tpu.ops import regex_rewrite as jrx
from spark_rapids_jni_tpu.ops import strings as js
from spark_rapids_jni_tpu.utils import tracing as jtracing

from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.columnar.interop import (HostColumn,
                                                         column_from_numpy)
from spark_rapids_jni_tpu_torch.ops import dictionary as pdict
from spark_rapids_jni_tpu_torch.ops import regex_rewrite as prx
from spark_rapids_jni_tpu_torch.ops import strings as ps
from spark_rapids_jni_tpu_torch.utils import tracing as ptracing

torch.set_num_threads(1)


def to_port(jc):
    return column_from_numpy(HostColumn.of(jc), device="cpu")


def assert_same(jc, pc):
    if jc.dtype.id.name == "LIST":
        assert pc.dtype.id.name == "LIST"
        assert (jc.validity is None) == (pc.validity is None)
        if jc.validity is not None:
            np.testing.assert_array_equal(np.asarray(jc.validity),
                                          pc.validity.numpy())
        np.testing.assert_array_equal(np.asarray(jc.offsets),
                                      pc.offsets.numpy())
        return assert_same(jc.children[0], pc.children[0])
    a, b = HostColumn.of(jc), HostColumn.of(pc)
    assert (a.type_id, a.scale) == (b.type_id, b.scale)
    assert (a.validity is None) == (b.validity is None)
    if a.validity is not None:
        np.testing.assert_array_equal(a.validity, b.validity)
    if a.chars is not None:
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_array_equal(a.chars, b.chars)
    else:
        np.testing.assert_array_equal(np.ascontiguousarray(a.data),
                                      np.ascontiguousarray(b.data))


VECTORS = ["hello", "", None, "héllo wörld", "a-b-c", "-lead", "trail-",
           "--", "  padded  ", "xxabxxabab", "日本語テキスト", "ab", "abab",
           "ABC def", "cat-1A", "cat-22B", "dog-3C", "aaaa", "x", "%_lit",
           "a\\b", "misty plum"]


@pytest.fixture(scope="module", params=["vectors", "text"])
def col(request):
    if request.param == "vectors":
        return JColumn.from_pylist(VECTORS)
    chars, offsets, valid = chip_smoke.text_strings(
        np.random.default_rng(21), 1200)
    return JColumn.string(chars, offsets, valid)


@pytest.mark.parametrize("fn,args", [
    ("byte_length", ()), ("char_length", ()), ("upper", ()), ("lower", ()),
    ("starts_with", ("ab",)), ("starts_with", ("",)), ("ends_with", ("b",)),
    ("ends_with", ("-bar",)), ("contains", ("ab",)), ("contains", ("t-",)),
    ("find", ("ab",)), ("find", ("",)), ("equal", ("ab",)),
    ("equal", ("",)), ("substring", (2,)), ("substring", (1, 3)),
    ("substring", (-3, 2)), ("substring", (0, 5)), ("substring", (4, 0)),
    ("replace", ("ab", "Z")), ("replace", ("-", "--")),
    ("replace", ("a", "")), ("replace", ("", "q")),
    ("split_part", ("-", 1)), ("split_part", ("-", 2)),
    ("split_part", ("-", -1)), ("split_part", ("ab", 3)),
    ("split", ("-",)), ("split", ("ab",)), ("split", (" ",)),
    ("trim", ()), ("ltrim", ()), ("rtrim", ("x ",)), ("trim", ("",)),
    ("lpad", (8, "*")), ("rpad", (6, "ab")), ("lpad", (2, " ")),
    ("like", ("%ab%",)), ("like", ("cat-_%",)), ("like", ("a_b%",)),
    ("like", ("%",)), ("like", ("\\%\\_lit",)), ("like", ("x",)),
])
def test_string_op_matches_jax(col, fn, args):
    assert_same(getattr(js, fn)(col, *args),
                getattr(ps, fn)(to_port(col), *args))


def test_equal_and_concat_two_columns(col):
    other = JColumn.from_pylist(list(reversed(
        [None if i % 5 == 0 else f"ab{i % 3}" for i in range(col.size)])))
    pc, po = to_port(col), to_port(other)
    assert_same(js.equal(col, col), ps.equal(pc, pc))
    assert_same(js.equal(col, other), ps.equal(pc, po))
    assert_same(js.concat(col, other), ps.concat(pc, po))
    assert_same(js.concat(col, col), ps.concat(pc, pc))


def test_string_errors_match_jax():
    jc = JColumn.from_pylist(VECTORS)
    pc = to_port(jc)
    for fn, args in (("split_part", ("", 1)), ("split_part", ("-", 0)),
                     ("split", ("",)), ("trim", ("é",)), ("lpad", (4, "")),
                     ("rpad", (4, "é"))):
        for mod, c in ((js, jc), (ps, pc)):
            with pytest.raises(ValueError):
                getattr(mod, fn)(c, *args)


PATTERNS = ["^cat", "^cat.*", "1A$", ".*1A$", "ab", ".*ab.*", "^ab$",
            "^a\\.b$", "a\\-b", "^.*x", "cat.*$", "", "^$", "a|b", "[0-9]+",
            "^cat-\\d+[A-Z]$", "(ab)+", "b.c"]


@pytest.mark.parametrize("pattern", PATTERNS)
def test_rewrite_matches_jax(pattern):
    assert prx.rewrite(pattern) == jrx.rewrite(pattern)


@pytest.mark.parametrize("pattern", ["^cat", "1A$", "ab", "^ab$",
                                     "^cat-\\d+[A-Z]$", "a|b", "[0-9]+"])
def test_regex_matches_matches_jax(col, pattern):
    host = prx.rewrite(pattern) is None
    before = ptracing.counter_value("ops.regex.host_fallback")
    jbefore = jtracing.counter_value("ops.regex.host_fallback")
    assert_same(jrx.regex_matches(col, pattern),
                prx.regex_matches(to_port(col), pattern))
    assert ptracing.counter_value("ops.regex.host_fallback") - before == \
        jtracing.counter_value("ops.regex.host_fallback") - jbefore == host
    if host:
        for mod, c in ((jrx, col), (prx, to_port(col))):
            with pytest.raises(ValueError):
                mod.regex_matches(c, pattern, fallback=False)


def test_dictionary_matches_jax(col):
    jcodes, jd = jdict.dictionary_encode(col)
    pcodes, pd = pdict.dictionary_encode(to_port(col))
    assert_same(jcodes, pcodes)
    assert_same(jd, pd)
    assert_same(jdict.dictionary_decode(jcodes, jd),
                pdict.dictionary_decode(pcodes, pd))


@pytest.mark.parametrize("nulls", [False, True])
def test_dictionary_fixed_width_matches_jax(nulls):
    rng = np.random.default_rng(8)
    vals = rng.integers(-50, 50, 700).astype(np.int64)
    valid = rng.random(700) > 0.2 if nulls else None
    from spark_rapids_jni_tpu import dtypes as jdt
    jc = JColumn.fixed(jdt.INT64, vals, validity=valid)
    jcodes, jd = jdict.dictionary_encode(jc)
    pcodes, pd = pdict.dictionary_encode(to_port(jc))
    assert_same(jcodes, pcodes)
    assert_same(jd, pd)
    assert_same(jdict.dictionary_decode(jcodes, jd),
                pdict.dictionary_decode(pcodes, pd))


def test_dictionary_empty():
    jc = JColumn.from_pylist([], None) if False else \
        JColumn.string(np.zeros(0, np.uint8), np.zeros(1, np.int32))
    jcodes, jd = jdict.dictionary_encode(jc)
    pcodes, pd = pdict.dictionary_encode(to_port(jc))
    assert_same(jcodes, pcodes)
    assert pd.size == jd.size == 0


def test_split_builds_on_the_column_device():
    pc = Column.from_pylist(["a-b", None, "c"], device="cpu")
    out = ps.split(pc, "-")
    assert out.to_pylist() == [["a", "b"], None, ["c"]]
    assert out.children[0].data.device.type == "cpu"
