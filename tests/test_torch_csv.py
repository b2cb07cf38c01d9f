"""The port's CSV reader and writer against the JAX package's.

The JAX ``read_csv`` asks pandas' C parser; the port's tokenizes with
Python's ``csv`` module and infers types itself.  Every case of
``tests/test_csv.py``, then tables of pandas' default NA spellings and
bool spellings (one row each), the inference order (int64, uint64 on an
int64 overflow, float64, bool, string) with its order-dependent and
sentinel quirks, forced dtypes, and floats parsed as pandas parses them
(not correctly rounded): both readers read the same file and the tables
must be equal, bit for bit.  ``write_csv`` writes the same bytes as the
JAX writer.  One file is read with ``sys.modules["pandas"] = None``.
"""

import sys

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import dtypes as jdt
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.io import read_csv as jread
from spark_rapids_jni_tpu.io import write_csv as jwrite

from spark_rapids_jni_tpu_torch import dtypes as pdt
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.io import csv as pcsv
from spark_rapids_jni_tpu_torch.io import read_csv as pread
from spark_rapids_jni_tpu_torch.io import write_csv as pwrite
from spark_rapids_jni_tpu_torch.ops.selection import concat_tables, distinct

from test_torch_parquet_nested import same_table

torch.set_num_threads(1)
CPU = "cpu"


def read_both(tmp_path, text, pdtypes=None, jdtypes=None, **kw):
    p = tmp_path / "t.csv"
    p.write_text(text)
    j = jread(p, dtypes=jdtypes, **kw)
    t = pread(p, dtypes=pdtypes, device=CPU, **kw)
    same_table(j, t)
    return t


def test_inference_and_nulls(tmp_path):
    t = read_both(tmp_path,
                  "a,b,s,f\n1,true,x,1.5\n2,false,,2.5\n,true,zz,\n")
    assert t["a"].to_pylist() == [1, 2, None]
    assert t["s"].to_pylist() == ["x", None, "zz"]
    assert t["f"].to_pylist() == [1.5, 2.5, None]
    assert t["b"].to_pylist() == [True, False, True]


def test_forced_dtypes(tmp_path):
    t = read_both(tmp_path, "k,v\n1,10\n2,\n3,30\n",
                  {"k": pdt.INT32, "v": pdt.INT64},
                  {"k": jdt.INT32, "v": jdt.INT64})
    assert t["k"].dtype == pdt.INT32 and t["v"].dtype == pdt.INT64
    assert t["v"].to_pylist() == [10, None, 30]


def test_no_header_and_delimiter(tmp_path):
    t = read_both(tmp_path, "1|x\n2|y\n", delimiter="|", header=False,
                  names=["n", "s"])
    assert t["n"].to_pylist() == [1, 2]
    assert t["s"].to_pylist() == ["x", "y"]
    read_both(tmp_path, "1|x\n2|y\n", delimiter="|", header=False)


def test_matches_pandas_roundtrip(tmp_path):
    import pandas as pd
    rng = np.random.default_rng(0)
    n = 2000
    df = pd.DataFrame({
        "i": rng.integers(-10**9, 10**9, n),
        "f": rng.standard_normal(n),
        "s": [f"row{i % 101}" for i in range(n)],
    })
    p = tmp_path / "big.csv"
    df.to_csv(p, index=False)
    t = pread(p, device=CPU)
    same_table(jread(p), t)
    assert t["i"].to_pylist() == df["i"].tolist()
    assert t["s"].to_pylist() == df["s"].tolist()


def test_forced_string_preserves_text(tmp_path):
    t = read_both(tmp_path, "z\n007\n1.50\ntrue\n  x \n",
                  {"z": pdt.STRING}, {"z": jdt.STRING})
    assert t["z"].to_pylist() == ["007", "1.50", "true", "  x "]


def test_forced_bool(tmp_path):
    t = read_both(tmp_path, "i,b\n1,true\n2,false\n3,\n4,1\n5,0.0\n",
                  {"b": pdt.BOOL8}, {"b": jdt.BOOL8})
    assert t["b"].dtype == pdt.BOOL8
    assert t["b"].to_pylist() == [True, False, None, True, False]


def test_bool_with_nulls_inferred(tmp_path):
    t = read_both(tmp_path, "i,b\n1,true\n2,\n3,false\n")
    assert t["b"].dtype == pdt.BOOL8
    assert t["b"].to_pylist() == [True, None, False]


def test_nullable_int64_inference_exact(tmp_path):
    big = 9007199254740993  # 2^53 + 1: not representable in float64
    t = read_both(tmp_path, f"i,v\n1,{big}\n2,\n3,{big + 2}\n")
    assert t["v"].dtype == pdt.INT64
    assert t["v"].to_pylist() == [big, None, big + 2]


# pandas' default NA spellings and this reader's na_values, one row each
NA_SPELLINGS = sorted(pcsv.DEFAULT_NA | {"null", "NULL"}) + [
    "nil", "n/A", "none", "NAN", "-", " NA", "NA "]


def test_na_spellings(tmp_path):
    """Each spelling in its own row, in a STRING column and beside ints:
    pandas' set reads null, anything else is text."""
    rows = [f'{i},"{s}",7' for i, s in enumerate(NA_SPELLINGS)]
    t = read_both(tmp_path, "k,s,n\n" + "\n".join(rows) + "\n")
    got = t["s"].to_pylist()
    for s, g in zip(NA_SPELLINGS, got):
        assert (g is None) == (s in pcsv.DEFAULT_NA), s
    for s in sorted(pcsv.DEFAULT_NA):
        t = read_both(tmp_path, f'a,b\n1,"{s}"\n2,5\n')
        assert t["b"].to_pylist() == [None, 5], s


@pytest.mark.parametrize("words,kind", [
    (["True", "False", "TRUE", "FALSE", "true", "false"], "BOOL8"),
    (["True", "false", ""], "BOOL8"),
    (["true", "1"], "STRING"),
    (["t", "f"], "STRING"),
    (["yes", "no"], "STRING"),
    (["True", "tRUE", "fALSE"], "BOOL8"),
    (["TRUE ", "false"], "STRING"),
    ([" true", "false"], "STRING"),
    (["1", "0"], "INT64"),
    (["1.0", "0.0"], "FLOAT64"),
])
def test_bool_spellings(tmp_path, words, kind):
    t = read_both(tmp_path, "b\n" + "\n".join(
        f'"{w}"' for w in words) + "\n")
    assert t["b"].dtype.id.name == kind


U64 = "9223372036854775808"
OVER = "184467440737095516150"
INFER_CASES = {
    "spaces": "a\n 1\n2 \n\t3 \n",
    "signs": "a\n+5\n-3\n-0\n",
    "leading-zeros": "a\n007\n1\n",
    "uint64": f"a\n{U64}\n1\n",
    "uint64-max-sentinel": "a\n18446744073709551615\n5\n",
    "int64-min-sentinel": "a\n-9223372036854775808\n9223372036854775807\n",
    "uint64-and-negative": f"a\n{U64}\n-1\n",
    "uint64-negative-float": f"a\n{U64}\n-1\n1.5\n",
    "overflow-first": f"a\n{OVER}\n1.5\n",
    "overflow-after-float": f"a\n1.5\n{OVER}\n",
    "below-int64": "a\n-9223372036854775809\n",
    "floats": "a\n1e5\n.5\n5.\n+1.5\n1E+05\n-.5E-2\n 1.5e3 \n",
    "inf": "a\ninf\n-inf\nInfinity\n+inf\nINF\n-Infinity\niNf\n1.5\n",
    "inf-space": "a\ninf \n1.5\n",
    "huge-exponents": "a\n1e400\n-1e400\n0e400\n-0e400\n1e-400\n4.9e-324\n",
    "many-digits": "a\n0.000000000000000000000123456789012345678\n"
                   "00000000000000000000001.5\n123456789012345678\n",
    "long-exponent": "a\n1e000000000000000001\n",
    "not-numbers": "a\n1e\n.\n-\n+\n1.5.5\n1_000\n0x1p3\n",
    "mixed": "a\n1\nabc\n2.5\n",
    "all-null": "a,b\n,1\n,2\n",
    "header-only": "a,b\n",
    "blank-lines": "a\n1\n\n2\n\n",
    "short-row": "a,b,c\n1,2\n3,4,5\n",
    "duplicate-names": "a,a,b\n1,2,3\n",
    "unnamed": ",b\n1,2\n",
    "quoted": 'a,b\n"1",",x"\n" 2","y""z"\n"3","multi\nline"\n',
    "crlf": "a,b\r\n1,x\r\n2,y\r\n",
}


@pytest.mark.parametrize("name", sorted(INFER_CASES))
def test_inference_order_and_quirks(tmp_path, name):
    read_both(tmp_path, INFER_CASES[name])


def test_floats_parse_as_pandas(tmp_path):
    """Shortest round-trip reprs over the whole double range and random
    digit strings (up to 24 + 24 digits, exponents to +-330): every value
    bit for bit as pandas parses it."""
    rng = np.random.default_rng(7)
    with np.errstate(over="ignore"):
        x = np.concatenate([
            rng.standard_normal(4000),
            rng.standard_normal(4000) * 10.0 ** rng.integers(-320, 310, 4000)])
    texts = [repr(float(v)) for v in x if np.isfinite(v)]
    digits = np.array(list("0123456789"))
    for _ in range(4000):
        s = "".join(rng.choice(digits, rng.integers(1, 25)))
        if rng.random() < 0.7:
            s += "." + "".join(rng.choice(digits, rng.integers(0, 25)))
        if rng.random() < 0.4:
            s += f"e{int(rng.integers(-330, 330))}"
        texts.append(("-" if rng.random() < 0.3 else "") + s)
    t = read_both(tmp_path, "f\n" + "\n".join(texts) + "\n")
    assert t["f"].dtype == pdt.FLOAT64


@pytest.mark.parametrize("text,forced", [
    ("a\n1.0\n7\n \t8 \n", "INT64"),
    ("a\n3000000000\n-1\n", "INT32"),
    ("a\n-1\n300\n", "UINT8"),
    ("a\n0.1\n\n7\n1e39\n", "FLOAT32"),
    ("a\n1.5\ninf\n-0.0\n", "FLOAT64"),
    ("a\nTrue\nfalse\n\nTRUE\n", "FLOAT64"),
    ("a\n007\nNA\n", "STRING"),
    ("a\nNA\n\n", "STRING"),
])
def test_forced_parse(tmp_path, text, forced):
    read_both(tmp_path, text, {"a": getattr(pdt, forced)},
              {"a": getattr(jdt, forced)})


@pytest.mark.parametrize("text,forced", [
    ("a\n1.5\n", "INT64"), ("a\ntrue\n", "INT32"), ("a\nyes\n", "BOOL8"),
    ("a\nabc\n", "FLOAT64"), ("a\n1.5\nTrue\n", "FLOAT64")])
def test_forced_refusals(tmp_path, text, forced):
    p = tmp_path / "t.csv"
    p.write_text(text)
    with pytest.raises((ValueError, TypeError)):
        jread(p, dtypes={"a": getattr(jdt, forced)})
    with pytest.raises(ValueError):
        pread(p, dtypes={"a": getattr(pdt, forced)}, device=CPU)


def _writer_tables():
    j = JTable([
        JColumn.from_numpy(np.array([1, 2, 3], np.int64)),
        JColumn.from_pylist(["plain", None, 'has,"quote"\nline']),
        JColumn.from_numpy(np.array([1.5, -2.25, 0.0])),
        JColumn.from_numpy(np.array([True, False, True])),
    ], ["x", "s", "f", "b"])
    p = Table([
        Column.from_numpy(np.array([1, 2, 3], np.int64), device=CPU),
        Column.from_pylist(["plain", None, 'has,"quote"\nline'], device=CPU),
        Column.from_numpy(np.array([1.5, -2.25, 0.0]), device=CPU),
        Column.from_numpy(np.array([True, False, True]), device=CPU),
    ], ["x", "s", "f", "b"])
    return j, p


def test_write_roundtrip_with_quoting_and_nulls(tmp_path):
    jt, pt = _writer_tables()
    jp, pp = tmp_path / "j.csv", tmp_path / "p.csv"
    jwrite(jt, jp)
    pwrite(pt, pp)
    assert pp.read_bytes() == jp.read_bytes()
    back = pread(pp, device=CPU)
    same_table(jread(pp), back)
    assert back["x"].to_pylist() == [1, 2, 3]
    assert back["s"].to_pylist()[2] == 'has,"quote"\nline'
    assert back["b"].to_pylist() == [True, False, True]


def test_write_spark_text_forms(tmp_path):
    """NaN, infinities, decimals, nulls and another delimiter."""
    vals = [1.0, float("nan"), float("inf"), float("-inf"), None, 1e-300]
    jt = JTable([JColumn.from_pylist(vals, dtype=jdt.FLOAT64),
                 JColumn.from_numpy(np.array([1, -2, 3, 4, 5, 600]),
                                    dtype=jdt.decimal64(-2))], ["f", "d"])
    pt = Table([Column.from_pylist(vals, dtype=pdt.FLOAT64, device=CPU),
                Column.from_numpy(np.array([1, -2, 3, 4, 5, 600]),
                                  dtype=pdt.decimal64(-2), device=CPU)],
               ["f", "d"])
    jp, pp = tmp_path / "j.csv", tmp_path / "p.csv"
    jwrite(jt, jp, delimiter=";", na_rep="NULL")
    pwrite(pt, pp, delimiter=";", na_rep="NULL")
    assert pp.read_bytes() == jp.read_bytes()
    same_table(jread(pp, delimiter=";"), pread(pp, delimiter=";",
                                               device=CPU))


def test_without_pandas(tmp_path, monkeypatch):
    """With pandas (and pyarrow) blocked the port reads the same table."""
    rng = np.random.default_rng(3)
    n = 3000
    lines = ["i,f,s,b,u,q"]
    for k in range(n):
        lines.append(",".join([
            "" if k % 13 == 0 else str(int(rng.integers(-2**62, 2**62))),
            repr(float(rng.standard_normal() * 10.0 ** rng.integers(-5, 5))),
            "NA" if k % 7 == 0 else f"w{k % 31}",
            "true" if k % 3 else "false",
            str(int(rng.integers(0, 2**63)) + 2**63),
            f'"a,{k}"' if k % 5 else '"say ""hi"""']))
    p = tmp_path / "t.csv"
    p.write_text("\n".join(lines) + "\n")
    want = jread(p)
    monkeypatch.setitem(sys.modules, "pandas", None)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    got = pread(p, device=CPU)
    same_table(want, got)
    assert [c.dtype.id.name for c in got.columns] == \
        ["INT64", "FLOAT64", "STRING", "BOOL8", "UINT64", "STRING"]


def test_concat_tables_and_distinct():
    t1 = Table([Column.from_numpy(np.array([1, 2], np.int64), device=CPU),
                Column.from_pylist(["a", None], device=CPU)], ["x", "s"])
    t2 = Table([Column.from_numpy(np.array([2], np.int64), device=CPU),
                Column.from_pylist(["b"], device=CPU)], ["x", "s"])
    c = concat_tables([t1, t2])
    assert c.num_rows == 3
    assert c["s"].to_pylist() == ["a", None, "b"]
    d = distinct(c, subset=["x"])
    assert d["x"].to_pylist() == [1, 2]
    assert d["s"].to_pylist() == ["a", None]


# The reader's five former faults against the JAX reader: each repro, then
# a short seeded fuzz over the texts that reach it.  Forced refusals raise
# ValueError in the port, whatever the JAX reader's error class.
FAULT_CASES = {
    "1-spaces-line": ("a,b\n1,2\n  \n3,4\n", None),
    "1-tab-line": ("a\n1\n\t\n2\n", None),
    "1-spaces-then-header": (" \t\na\n1\n", None),
    "1-quoted-spaces-kept": ('a\n1\n"  "\n2\n', None),
    "2-beyond-uint64": ("c0\n007\n+18446744073709551616\n", None),
    "2-signs-and-spaces": ("c0\n+3\n 4\n-0\n18446744073709551616\n", None),
    "2-below-int64": ("c0\n-0009223372036854775809\n5\nnull\n", None),
    "2-text-keeps-raw": ("c0\n007\n18446744073709551616\nx\n", None),
    "3-na-beside-above-int64": ("c0\n9223372036854775808\nnull\n", None),
    "3-empty-beside-uint64-max": ("a,b\n18446744073709551615,1\n,2\n",
                                  None),
    "3-sign-beside-above-int64": ("c0\n-0\n9223372036854775808\n", None),
    "4-integer-text-wraps": ("c0\n1\n-129\n", "INT8"),
    "4-integral-float-fits": ("c0\n1.0\nnull\n300\n", "INT16"),
    "5-int64": ("c0\n9223372036854775808\n", "INT64"),
    "5-int8": ("c0\n9223372036854775808\n", "INT8"),
    "5-uint32": ("c0\n18446744073709551615\n", "UINT32"),
    "5-uint64-beside-na": ("c0\n255\n9223372036854775808\nnull\n",
                           "UINT64"),
}


@pytest.mark.parametrize("name", sorted(FAULT_CASES))
def test_former_faults_match_jax(tmp_path, name):
    text, forced = FAULT_CASES[name]
    kw = {} if forced is None else {"pdtypes": {"c0": getattr(pdt, forced)},
                                    "jdtypes": {"c0": getattr(jdt, forced)}}
    read_both(tmp_path, text, **kw)


@pytest.mark.parametrize("text,forced", [
    ("c0\n1e5\n", "INT16"), ("c0\n0.0\n-129\n", "INT8"),
    ("c0\n2.0\n300\n", "UINT8"), ("c0\n1.0\ninf\n", "INT64"),
    ("c0\n9223372036854775808\nnull\n", "INT64"),
    ("c0\n-1\n9223372036854775808\n", "UINT64"),
    ("c0\n18446744073709551616\n", "UINT64")])
def test_forced_refusals_of_former_faults(tmp_path, text, forced):
    p = tmp_path / "t.csv"
    p.write_text(text)
    with pytest.raises((ValueError, TypeError, OverflowError)):
        jread(p, dtypes={"c0": getattr(jdt, forced)})
    with pytest.raises(ValueError):
        pread(p, dtypes={"c0": getattr(pdt, forced)}, device=CPU)


FUZZ_POOLS = {
    1: ["1", "x", "  ", "\t", " \t ", '"  "', "2.5", ""],
    2: ["007", "+3", " 4", "-0", "-1", "18446744073709551616",
        "-9223372036854775809", "x", "1.5", "null"],
    3: ["1", "-0", "9223372036854775808", "18446744073709551615", "null",
        "NA", "", "x"],
    4: ["1", "-129", "300", "0.0", "1.0", "2.5", "1e5", "-1.0", "null"],
    5: ["1", "-1", "9223372036854775808", "18446744073709551615",
        "18446744073709551616", "-9223372036854775809", "null"],
}


@pytest.mark.parametrize("fault", sorted(FUZZ_POOLS))
def test_former_faults_seeded_fuzz(tmp_path, fault):
    """40 random one-column files a fault: equal tables, or both refuse."""
    rng = np.random.default_rng(100 + fault)
    pool = FUZZ_POOLS[fault]
    forced = ["INT8", "INT16", "UINT8", "UINT32", "INT64", "UINT64"]
    p = tmp_path / "t.csv"
    for _ in range(40):
        cells = [pool[i] for i in rng.integers(0, len(pool),
                                               rng.integers(1, 6))]
        p.write_text("c0\n" + "\n".join(cells) + "\n")
        name = forced[rng.integers(len(forced))] if fault >= 4 else None
        jd = None if name is None else {"c0": getattr(jdt, name)}
        pd_ = None if name is None else {"c0": getattr(pdt, name)}
        try:
            want = jread(p, dtypes=jd)
        except (ValueError, TypeError, OverflowError):
            with pytest.raises(ValueError):
                pread(p, dtypes=pd_, device=CPU)
            continue
        same_table(want, pread(p, dtypes=pd_, device=CPU))
