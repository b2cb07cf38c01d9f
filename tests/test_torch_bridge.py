"""The port's device server, reached by the JAX package's unchanged client.

``spark_rapids_jni_tpu_torch.bridge.server`` runs as its own process with
``--device cpu`` (one server for the module).  The JAX package's
``BridgeClient`` drives tests/test_bridge.py's sequences against it: the
RowConversionTest round trip on the 8-column fixture, STRING import and
export, error discipline, concurrent clients, hash/get_column,
cast_strings, groupby and join, read_parquet, sort/filter/concat.  Every
exported table is held bit for bit (data of valid rows, validity, offsets)
against the JAX package's in-process result of the same op; the C ABI
harness (``bridge_roundtrip_test``) runs against the same server.
"""

import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu import dtypes as dt
from spark_rapids_jni_tpu.bridge import BridgeClient
from spark_rapids_jni_tpu.bridge import protocol as JP
from spark_rapids_jni_tpu.columnar import Column, Table
from spark_rapids_jni_tpu_torch.bridge import protocol as TP
from spark_rapids_jni_tpu_torch.bridge import spawn_server

from test_bridge import C_HARNESS, REPO, reference_test_table

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("torch_bridge") / "tpub.sock")
    proc = spawn_server(sock, device="cpu")
    yield sock, proc
    try:
        BridgeClient(sock).shutdown_server()
    except (OSError, RuntimeError):
        proc.kill()
    proc.wait(timeout=30)


def _bytes(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def assert_same_column(got, want, what=""):
    assert got.dtype == want.dtype, what
    gv, wv = got.validity_numpy(), want.validity_numpy()
    np.testing.assert_array_equal(gv, wv, err_msg=f"{what} validity")
    if want.dtype.is_string:
        np.testing.assert_array_equal(np.asarray(got.offsets),
                                      np.asarray(want.offsets),
                                      err_msg=f"{what} offsets")
        assert got.to_pylist() == want.to_pylist(), what
        return
    g, w = np.asarray(got.data), np.asarray(want.data)
    assert g.shape == w.shape, what
    np.testing.assert_array_equal(_bytes(g[gv]), _bytes(w[wv]),
                                  err_msg=f"{what} data")


def assert_same_table(got, want):
    assert got.num_columns == want.num_columns
    assert got.num_rows == want.num_rows
    for i, (g, w) in enumerate(zip(got.columns, want.columns)):
        assert_same_column(g, w, f"col {i}")


def _export_col(c, h):
    th = c.make_table([h])
    out = c.export_table(th).columns[0]
    c.release(th)
    return out


def test_protocol_is_a_copy():
    def same(a, b):
        return a.format == b.format if hasattr(a, "format") else a == b
    names = [n for n in dir(JP) if n.isupper()]
    assert names and all(same(getattr(TP, n), getattr(JP, n))
                         for n in names)
    assert TP.PROTOCOL_VERSION == 2 and TP.TRACE_FLAG == 0x80


def test_python_client_roundtrip(server):
    from spark_rapids_jni_tpu.ops.row_conversion import (convert_from_rows,
                                                         convert_to_rows)
    sock, proc = server
    c = BridgeClient(sock)
    t = reference_test_table()
    schema = t.dtypes()
    h = c.import_table(t)
    blobs = c.convert_to_rows(h)
    assert len(blobs) == 1  # 6 rows never overflow a batch
    offs, raw = c.export_rows_column(blobs[0])
    want_blob = convert_to_rows(t)[0]
    np.testing.assert_array_equal(offs, np.asarray(want_blob.offsets))
    np.testing.assert_array_equal(
        raw, _bytes(np.asarray(want_blob.children[0].data)))
    h2 = c.convert_from_rows(blobs[0], schema)
    nrows, meta = c.table_meta(h2)
    assert nrows == 6 and meta == schema
    got = c.export_table(h2)
    assert_same_table(got, t)
    assert_same_table(got, convert_from_rows(want_blob, schema))
    for handle in [h, blobs[0], h2]:
        c.release(handle)
    assert c.live_count() == 0
    with pytest.raises(RuntimeError, match="invalid or released"):
        c.release(h)
    c.ping()
    c.close()
    assert proc.poll() is None


@pytest.mark.parametrize("dtype,values", [
    (dt.UINT32, np.array([0, 1, 2**31, 2**32 - 1, 7], np.uint32)),
    (dt.UINT64, np.array([0, 2**63, 2**64 - 1, 5, 9], np.uint64)),
    (dt.INT16, np.array([-2**15, 0, 2**15 - 1, 3, -3], np.int16)),
    (dt.FLOAT64, np.array([np.nan, -0.0, np.inf, 1e-310, 2.5])),
    (dt.FLOAT32, np.array([np.nan, -0.0, -np.inf, 1e-40, 2.5], np.float32)),
    (dt.TIMESTAMP_DAYS, np.array([-719162, 0, 18000, 2932896, 1], np.int32)),
    (dt.decimal128(-4), np.array([0, -1, 2**100, -(2**120), 12345],
                                 object)),
])
def test_fixed_width_import_export(server, dtype, values):
    """Every storage family crosses shm and the card's tensors bit for bit,
    with a null, as the JAX package holds it."""
    from spark_rapids_jni_tpu.ops.row_conversion import (convert_from_rows,
                                                         convert_to_rows)
    sock, _ = server
    c = BridgeClient(sock)
    valid = np.array([1, 1, 0, 1, 1], np.bool_)
    t = Table([Column.fixed(dtype, values, valid)])
    h = c.import_table(t)
    assert_same_table(c.export_table(h), t)
    blobs = c.convert_to_rows(h)
    offs, raw = c.export_rows_column(blobs[0])
    want = convert_to_rows(t)[0]
    np.testing.assert_array_equal(offs, np.asarray(want.offsets))
    np.testing.assert_array_equal(raw,
                                  _bytes(np.asarray(want.children[0].data)))
    h2 = c.convert_from_rows(blobs[0], [dtype])
    assert_same_table(c.export_table(h2),
                      convert_from_rows(want, [dtype]))
    for x in [h, *blobs, h2]:
        c.release(x)
    c.close()


def test_string_column_import_export(server):
    from spark_rapids_jni_tpu.ops.row_conversion import convert_to_rows
    sock, _ = server
    c = BridgeClient(sock)
    t = Table([
        Column.from_pylist(["spark", "", None, "rapids", "tpu"]),
        Column.from_numpy(np.arange(5, dtype=np.int64)),
    ])
    h = c.import_table(t)
    got = c.export_table(h)
    assert got.columns[0].to_pylist() == ["spark", "", None, "rapids", "tpu"]
    assert_same_table(got, t)
    # the variable-width row wire, byte for byte
    blobs = c.convert_to_rows(h)
    offs, raw = c.export_rows_column(blobs[0])
    want = convert_to_rows(t)[0]
    np.testing.assert_array_equal(offs, np.asarray(want.offsets))
    np.testing.assert_array_equal(raw,
                                  _bytes(np.asarray(want.children[0].data)))
    for x in [h, *blobs]:
        c.release(x)
    assert c.live_count() == 0
    c.close()


def test_error_discipline(server):
    """CATCH_STD analog: bad requests error back; the server survives."""
    sock, proc = server
    c = BridgeClient(sock)
    with pytest.raises(RuntimeError, match="invalid or released"):
        c.convert_to_rows(999999)
    t = Table([Column.from_numpy(np.arange(4, dtype=np.int64))])
    h = c.import_table(t)
    with pytest.raises(RuntimeError):  # table handle where column expected
        c.convert_from_rows(h, [dt.INT64])
    blobs = c.convert_to_rows(h)
    with pytest.raises(RuntimeError, match="width mismatch"):
        c.convert_from_rows(blobs[0], [dt.INT8])  # wrong schema
    for x in [h, *blobs]:
        c.release(x)
    assert c.live_count() == 0
    c.close()
    assert proc.poll() is None


def test_concurrent_clients(server):
    """Connection B is served while A idles between ops, and interleaved
    ops from four threads keep the handle bookkeeping consistent."""
    sock, _ = server
    a = BridgeClient(sock)
    ha = a.import_table(
        Table([Column.from_numpy(np.arange(8, dtype=np.int64))]))
    b = BridgeClient(sock)
    hb = b.import_table(
        Table([Column.from_numpy(np.arange(4, dtype=np.int64))]))
    np.testing.assert_array_equal(
        np.asarray(b.export_table(hb).columns[0].data), np.arange(4))
    b.release(hb)
    b.close()
    assert a.export_table(ha).num_rows == 8

    errors = []

    def hammer(i):
        try:
            cc = BridgeClient(sock)
            t = Table([Column.from_numpy(np.arange(16, dtype=np.int64) + i)])
            for _ in range(10):
                h = cc.import_table(t)
                blobs = cc.convert_to_rows(h)
                h2 = cc.convert_from_rows(blobs[0], [dt.INT64])
                out = cc.export_table(h2)
                np.testing.assert_array_equal(np.asarray(out.columns[0].data),
                                              np.arange(16) + i)
                for x in [h, *blobs, h2]:
                    cc.release(x)
            cc.close()
        except Exception as e:  # noqa: BLE001 -- surfaced below
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    a.release(ha)
    assert a.live_count() == 0
    a.close()


def _harness(tmp_path_factory):
    """tests/test_bridge.py's harness when it is built; else the same
    cmake build into a directory of this test's own (so two test workers
    never build into one directory at once); None where ``_native_built``
    would find no toolchain."""
    if os.path.exists(C_HARNESS):
        return C_HARNESS
    if shutil.which("cmake") is None:
        return None
    build = str(tmp_path_factory.mktemp("cmake_build"))
    try:
        subprocess.run(["cmake", "-S", os.path.join(REPO, "src/main/cpp"),
                        "-B", build, "-G", "Ninja"],
                       check=True, capture_output=True, timeout=120)
        subprocess.run(["cmake", "--build", build],
                       check=True, capture_output=True, timeout=300)
    except (subprocess.SubprocessError, OSError):
        return None
    harness = os.path.join(build, "bridge_roundtrip_test")
    return harness if os.path.exists(harness) else None


def test_c_abi_roundtrip(server, tmp_path_factory):
    """The native client: C ABI, only handles cross per op."""
    harness = _harness(tmp_path_factory)
    if harness is None:
        pytest.skip("native toolchain unavailable")
    sock, proc = server
    out = subprocess.run([harness, sock], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, f"\nstdout:{out.stdout}\nstderr:{out.stderr}"
    assert "0 leaks" in out.stdout
    assert proc.poll() is None


def test_bridge_hash_and_get_column(server):
    from spark_rapids_jni_tpu.ops.hash import murmur3_hash, xxhash64
    sock, _ = server
    c = BridgeClient(sock)
    rng = np.random.default_rng(5)
    valid = rng.random(100) > 0.1
    t = Table([Column.from_numpy(rng.integers(-2**62, 2**62, 100)),
               Column.from_numpy(np.arange(100, dtype=np.int32), valid),
               Column.from_pylist([f"s{i}" if i % 7 else None
                                   for i in range(100)])])
    th = c.import_table(t)
    hh = c.hash(th, "murmur3")
    assert_same_column(_export_col(c, hh), murmur3_hash(t), "murmur3")
    xh = c.hash(th, "xxhash64", seed=7)
    assert_same_column(_export_col(c, xh), xxhash64(t, seed=7), "xxhash64")
    ch = c.get_column(th, 2)
    assert_same_column(_export_col(c, ch), t.columns[2], "get_column")
    for h in (th, hh, xh, ch):
        c.release(h)
    c.close()


@pytest.mark.parametrize("dtype,ansi,strip", [
    (dt.INT64, False, True), (dt.INT32, False, False),
    (dt.FLOAT64, False, True), (dt.decimal64(-2), False, True),
])
def test_bridge_cast_strings(server, dtype, ansi, strip):
    from spark_rapids_jni_tpu.ops.cast import cast
    from spark_rapids_jni_tpu.ops.strings import trim
    sock, _ = server
    c = BridgeClient(sock)
    col = Column.from_pylist(["12", " 34 ", "x", "-5", None, "1.25",
                              "9223372036854775808", " -0.5 "])
    th = c.import_table(Table([col]))
    ch = c.get_column(th, 0)
    casth = c.cast_strings(ch, dtype, ansi=ansi, strip=strip)
    want = cast(trim(col) if strip else col, dtype, ansi=ansi)
    assert_same_column(_export_col(c, casth), want, "cast_strings")
    for h in (th, ch, casth):
        c.release(h)
    c.close()


def test_bridge_groupby_and_join(server):
    from spark_rapids_jni_tpu.ops.aggregate import groupby
    from spark_rapids_jni_tpu.ops.join import sort_merge_join
    sock, _ = server
    c = BridgeClient(sock)
    rng = np.random.default_rng(0)
    k = rng.integers(0, 20, 500).astype(np.int64)
    v = rng.integers(-50, 50, 500).astype(np.int64)
    t = Table([Column.from_numpy(k), Column.from_numpy(v)])
    th = c.import_table(t)
    aggs = [(1, JP.AGG_SUM), (1, JP.AGG_COUNT), (1, JP.AGG_MIN),
            (1, JP.AGG_MAX), (1, JP.AGG_MEAN), (0, JP.AGG_COUNT_ALL)]
    gh = c.groupby(th, [0], aggs)
    names = ["c0", "c1"]
    want = groupby(Table(list(t.columns), names), ["c0"],
                   [(names[ci] if ac != JP.AGG_COUNT_ALL else None,
                     JP.AGG_NAMES[ac]) for ci, ac in aggs])
    assert_same_table(c.export_table(gh), want)

    rk = np.arange(20, dtype=np.int64)
    r = Table([Column.from_numpy(rk), Column.from_numpy(rk * 10)])
    rh = c.import_table(r)
    for how in ("inner", "left", "semi", "anti"):
        jh = c.join(th, rh, [0], [0], how)
        want = sort_merge_join(Table(list(t.columns), ["l0", "l1"]),
                               Table(list(r.columns), ["r0", "r1"]),
                               ["l0"], ["r0"], how=how)
        assert_same_table(c.export_table(jh), want)
        c.release(jh)
    for h in (th, gh, rh):
        c.release(h)
    c.close()


def test_bridge_read_parquet(server, tmp_path):
    from spark_rapids_jni_tpu.io import read_parquet
    sock, _ = server
    c = BridgeClient(sock)
    rng = np.random.default_rng(1)
    a = rng.integers(0, 1000, 2000).astype(np.int64)
    b = rng.standard_normal(2000)
    s = pa.array([None if i % 9 == 0 else f"v{i % 31}" for i in range(2000)])
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"a": a, "b": b, "s": s}), path,
                   row_group_size=512)
    th = c.read_parquet(path)
    assert c.table_meta(th)[0] == 2000
    assert_same_table(c.export_table(th), read_parquet(path))
    th2 = c.read_parquet(path, columns=["b"])
    nrows2, schema2 = c.table_meta(th2)
    assert nrows2 == 2000 and len(schema2) == 1
    assert_same_table(c.export_table(th2), read_parquet(path, columns=["b"]))
    for h in (th, th2):
        c.release(h)
    c.close()


def test_bridge_engine_op_errors(server):
    sock, proc = server
    c = BridgeClient(sock)
    th = c.import_table(
        Table([Column.from_numpy(np.arange(5, dtype=np.int64))]))
    with pytest.raises(RuntimeError, match="out of range"):
        c.get_column(th, 3)
    with pytest.raises(RuntimeError):
        c.hash(999999)           # bad handle
    with pytest.raises(RuntimeError):
        c.groupby(th, [0], [(0, 99)])  # unknown aggregation code
    c.release(th)
    c.close()
    assert proc.poll() is None


def test_bridge_sort_filter_concat(server):
    from spark_rapids_jni_tpu.ops.order import SortKey
    from spark_rapids_jni_tpu.ops.selection import (apply_boolean_mask,
                                                    concat_tables, sort_table)
    sock, _ = server
    c = BridgeClient(sock)
    base = c.live_count()
    kv = np.array([3, 1, 2, 1, 0], np.int64)
    valid = np.array([1, 1, 1, 1, 0], bool)
    t = Table([Column.from_numpy(kv, validity=valid),
               Column.from_numpy(np.arange(5, dtype=np.int64)),
               Column.from_pylist(["c", "a", None, "b", "e"])])
    th = c.import_table(t)
    for asc, nf in ((True, None), (False, False), (True, True)):
        sh = c.sort(th, [(0, asc, nf)])
        want = sort_table(t, [SortKey(t.columns[0], ascending=asc,
                                      nulls_first=nf)])
        assert_same_table(c.export_table(sh), want)
        c.release(sh)
    m = Table([Column.from_numpy(np.array([1, 0, 1, 1, 1], np.uint8),
                                 validity=np.array([1, 1, 1, 0, 1], bool),
                                 dtype=dt.BOOL8)])
    mth = c.import_table(m)
    mh = c.get_column(mth, 0)
    fh = c.filter(th, mh)
    assert_same_table(c.export_table(fh), apply_boolean_mask(t, m.columns[0]))
    ch = c.concat([th, th])
    assert_same_table(c.export_table(ch), concat_tables([t, t]))
    for h in (th, mth, mh, fh, ch):
        c.release(h)
    assert c.live_count() == base
    c.close()


def test_server_without_a_card_exits_with_the_device_error(tmp_path):
    """Started without ``--device cpu`` where torch sees no card, the
    server exits with ``device.resolve``'s error: nothing falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the server would serve")
    sock = str(tmp_path / "nocard.sock")
    out = subprocess.run(
        [sys.executable, "-m", "spark_rapids_jni_tpu_torch.bridge.server",
         "--socket", sock], capture_output=True, text=True, timeout=120,
        cwd=str(Path(__file__).resolve().parents[1]))
    assert out.returncode != 0
    assert "torch sees no CUDA card" in out.stderr
    assert not os.path.exists(sock)
    with pytest.raises(RuntimeError, match="bridge server died"):
        spawn_server(str(tmp_path / "nocard2.sock"))


@pytest.mark.parametrize("text,want", [
    ("result_cache=8", ("result_cache", 8)),
    ("sched=off", ("sched", False)),
    ("admission_queue_s=0.25", ("admission_queue_s", 0.25)),
    ("shards=none", ("shards", None)),
    ("faults=parquet.device_decode:1:io_error",
     ("faults", "parquet.device_decode:1:io_error")),
    ("blackbox_dir=/tmp/bb", ("blackbox_dir", "/tmp/bb")),
])
def test_server_settings_parse(text, want):
    from spark_rapids_jni_tpu_torch.utils.config import parse_setting
    assert parse_setting(text) == want


@pytest.mark.parametrize("bad", ["nosuch=1", "result_cache", "sched=maybe",
                                 "max_sessions=x"])
def test_server_settings_reject(bad):
    from spark_rapids_jni_tpu_torch.utils.config import parse_setting
    with pytest.raises(ValueError):
        parse_setting(bad)


def test_server_imports_with_jax_blocked():
    """A fresh interpreter that refuses every ``jax`` and
    ``spark_rapids_jni_tpu`` import loads the server, its client and what
    stands behind them."""
    code = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "spark_rapids_jni_tpu"):
            raise ImportError("blocked " + name)
sys.meta_path.insert(0, Block())
import spark_rapids_jni_tpu_torch.bridge.server
import spark_rapids_jni_tpu_torch.bridge.client
import spark_rapids_jni_tpu_torch.engine.scheduler
import spark_rapids_jni_tpu_torch.utils.blackbox
import spark_rapids_jni_tpu_torch.utils.faults
print(sorted(m for m in sys.modules if m.split(".")[0] == "jax"))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
