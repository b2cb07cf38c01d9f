"""The port's device-decode path against the JAX package's, on the CPU.

- ``plan_device_group``: the same ``ColumnGeom``s and byte-identical planes.
- ``decode_table``: bit-exact against the JAX ``decode_table`` on files that
  cover every class of TestGoldenParity's matrix (codec x encoding x width x
  nulls, all-null columns, several pages, and snappy pages with copies), and
  against pyarrow on the whole matrix (tests/test_device_decode.py
  ``TestGoldenParity``, which holds the JAX decoder to pyarrow on the same
  cells), with zeroed null slots and pad rows.  The JAX side runs jitted,
  one compile per chunk geometry, so its geometries are kept few and small.
- The plain versions of the kernels against the JAX functions they replace:
  K3 (``plain_gather``) against ``assemble_u32`` run through the Pallas
  interpreter and against ``_plain_gather``; W1 (``snappy_walk``) and W2's
  walk (``hybrid_walk_plain``) against ``_snappy_pass1`` and
  ``_hybrid_pass1``, on real and on torn (random) pages.
- ``TruncatedPageError`` and the fallback reasons.

The port runs on the CPU (``device="cpu"``), where every kernel wrapper
takes its plain version.  Tolerance: bit-exact throughout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import chip_smoke
from spark_rapids_jni_tpu.io import parquet as jpq
from spark_rapids_jni_tpu.ops import parquet_decode as jpd
from spark_rapids_jni_tpu_torch.io import parquet as ppq
from spark_rapids_jni_tpu_torch.kernels import parquet_decode as pqk
from spark_rapids_jni_tpu_torch.ops import parquet_decode as ppd
from spark_rapids_jni_tpu_torch.utils.errors import TransientError

torch.set_num_threads(1)
CPU = "cpu"
N = 1200
DTYPES = ["int32", "int64", "float32", "float64", "bool"]
_jit_decode = jax.jit(jpd.decode_table, static_argnums=1)


def _column(rng, dtype, nulls, n=N):
    """tests/test_device_decode.py's column generator."""
    if dtype == "bool":
        vals, typ = rng.integers(0, 2, n).astype(bool), pa.bool_()
    elif dtype.startswith("float"):
        vals = (rng.integers(-1000, 1000, n) * 0.25).astype(dtype)
        typ = pa.float32() if dtype == "float32" else pa.float64()
    else:
        lo, hi = (-(1 << 30), 1 << 30) if dtype == "int32" else \
            (-(1 << 60), 1 << 60)
        vals = rng.integers(lo, hi, n).astype(dtype)
        typ = pa.int32() if dtype == "int32" else pa.int64()
    mask = None if nulls == "none" else (
        np.ones(n, bool) if nulls == "all" else rng.random(n) < 0.25)
    return pa.array(vals, type=typ, mask=mask)


def golden_cells(rng):
    """TestGoldenParity's matrix as the columns of one file:
    {name: (array, codec, dictionary)}."""
    cells = {}
    for dtype in DTYPES:
        for nulls in ("none", "sparse", "all"):
            cells[f"sp_{dtype}_{nulls}"] = (_column(rng, dtype, nulls),
                                            "snappy", False)
    for dtype in ("int64", "float64"):
        for nulls in ("none", "sparse"):
            cells[f"un_{dtype}_{nulls}"] = (_column(rng, dtype, nulls),
                                            "none", False)
    for codec in ("snappy", "none"):
        for nulls in ("none", "sparse", "all"):
            vals = rng.integers(0, 17, N).astype(np.int64) * 1001
            mask = None if nulls == "none" else (
                np.ones(N, bool) if nulls == "all" else rng.random(N) < 0.25)
            cells[f"dict_{codec}_{nulls}"] = (
                pa.array(vals, pa.int64(), mask=mask), codec, True)
    return cells


def write_cells(path, cells, **kw):
    pq.write_table(pa.table({k: v[0] for k, v in cells.items()}), path,
                   compression={k: v[1] for k, v in cells.items()},
                   use_dictionary=[k for k, v in cells.items() if v[2]],
                   **kw)


# the JAX-side parity file: one cell of each class the multi-page file
# does not cover (kept small: every column is part of one jit compile)
PARITY_CELLS = ["sp_int32_sparse", "sp_float32_all", "un_int64_sparse",
                "dict_snappy_sparse", "dict_none_all"]


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    root = tmp_path_factory.mktemp("golden")
    cells = golden_cells(np.random.default_rng(11))
    write_cells(root / "g.parquet", cells, row_group_size=N // 2)
    write_cells(root / "p.parquet", {k: cells[k] for k in PARITY_CELLS},
                row_group_size=N)
    rng = np.random.default_rng(14)
    pq.write_table(pa.table({
        "i": _column(rng, "int64", "sparse", 4000),
        "f": _column(rng, "float64", "none", 4000),
        "b": _column(rng, "bool", "sparse", 4000),
    }), root / "multi.parquet", row_group_size=4000, compression="snappy",
        use_dictionary=False, data_page_size=4096)
    copies = chip_smoke.matrix_columns(3000, 2, "plain", "sparse", True)
    chip_smoke.write_parquet(root / "copies.parquet",
                             [c for c in copies if c[0] == "int64"], 3000,
                             "snappy", True, page_bytes=8192)
    return root


def geom_key(g):
    """A ColumnGeom as plain values (dtypes compared by id and scale)."""
    d = dataclasses.asdict(g)
    d["dtype"] = (int(g.dtype.id), g.dtype.scale)
    return d


def plan_both(path, gi, columns=None):
    jc, jr = jpq.plan_device_group(jpq.ParquetFile(path), gi, columns,
                                   1 << 30)
    pc, pr = ppq.plan_device_group(ppq.ParquetFile(path), gi, columns,
                                   1 << 30, device=CPU)
    assert jr == pr
    return jc, pc


def assert_tables_bit_equal(jt, pt):
    assert list(jt.names) == list(pt.names)
    for name, jc, pc in zip(jt.names, jt.columns, pt.columns):
        a = np.ascontiguousarray(np.asarray(jc.data)).view(np.uint8)
        b = pc.data.contiguous().numpy().view(np.uint8)
        np.testing.assert_array_equal(a, b, name)
        assert (jc.validity is None) == (pc.validity is None), name
        if jc.validity is not None:
            np.testing.assert_array_equal(np.asarray(jc.validity),
                                          pc.validity.numpy(), name)


@pytest.mark.parametrize("name", ["g", "multi", "copies"])
def test_plan_device_group_matches_jax(golden, name):
    path = golden / f"{name}.parquet"
    for gi in range(jpq.ParquetFile(path).num_row_groups):
        jc, pc = plan_both(path, gi)
        assert (jc.nrows, jc.comp_bytes, jc.unc_bytes) == \
            (pc.nrows, pc.comp_bytes, pc.unc_bytes)
        assert jc.geom.rb == pc.geom.rb
        assert [geom_key(g) for g in jc.geom.columns] == \
            [geom_key(g) for g in pc.geom.columns]
        for col, planes in jc.planes.items():
            for k, v in planes.items():
                np.testing.assert_array_equal(v, pc.planes[col][k])
                assert v.dtype == pc.planes[col][k].dtype
        if name == "multi":
            assert pc.geom.column("i").npages > 1
        if name == "copies":
            assert pc.geom.columns[0].has_copies


@pytest.mark.parametrize("name", ["p", "multi", "copies"])
def test_decode_table_matches_jax(golden, name):
    path = golden / f"{name}.parquet"
    for gi in range(jpq.ParquetFile(path).num_row_groups):
        jc, pc = plan_both(path, gi)
        want = _jit_decode(jc.to_device(), jc.geom)
        got = ppd.decode_table(pc.to_device(CPU), pc.geom)
        assert_tables_bit_equal(want, got)


def test_decode_table_golden_matrix(golden):
    """Every TestGoldenParity cell against pyarrow; null slots and pad rows
    hold zero bits and False validity, as the JAX decoder's do."""
    path = golden / "g.parquet"
    ref = pq.ParquetFile(path)
    pf = ppq.ParquetFile(path)
    for gi in range(pf.num_row_groups):
        chunk, reason = ppq.plan_device_group(pf, gi, None, 1 << 30, CPU)
        assert chunk is not None, reason
        table = ppd.decode_table(chunk.to_device(CPU), chunk.geom)
        rg = ref.read_row_group(gi)
        n = chunk.nrows
        assert n == rg.num_rows and table.num_rows == chunk.geom.rb
        for name, col in zip(table.names, table.columns):
            arr = rg[name].combine_chunks()
            valid = ~np.asarray(arr.is_null())
            got = col.data.numpy()
            assert col.validity is not None  # pyarrow writes OPTIONAL
            np.testing.assert_array_equal(col.validity.numpy()[:n], valid)
            assert not col.validity.numpy()[n:].any()
            assert not got.view(np.uint8).reshape(len(got), -1)[
                np.concatenate([~valid, np.ones(len(got) - n, bool)])].any()
            want = arr.drop_null().to_numpy(zero_copy_only=False)
            np.testing.assert_array_equal(
                got[:n][valid].view(np.uint8),
                want.astype(got.dtype).view(np.uint8), name)
        if gi == 0:
            assert chunk.geom.column("dict_snappy_sparse").encoding == "dict"


# -- the kernels' plain versions against the JAX functions -------------------

def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_k3_plain_matches_pallas_interpreter():
    rng = np.random.default_rng(15)
    b = rng.integers(0, 256, (2, 512, 4), dtype=np.uint8)
    want = jpd.assemble_u32(jnp.asarray(b), force_pallas=True,
                            interpret=True)
    # the (blk, 512) -> (blk, 128) contract as a K3 call: contiguous
    # values, voff 0, nn = arange
    unc = torch.from_numpy(b.reshape(2, 2048))
    nn = torch.arange(512, dtype=torch.int32).expand(2, 512).contiguous()
    got = pqk.plain_gather(unc, torch.zeros(2, dtype=torch.int32), nn, 4)
    np.testing.assert_array_equal(_np(want).view(np.int32), got.numpy())


@pytest.mark.parametrize("dtype", ["int32", "float64"])
def test_k3_plain_matches_plain_gather(dtype):
    """Per-slot offsets past the row end, null slots (-1) and offsets that
    start inside the row: every byte clipped on its own."""
    from spark_rapids_jni_tpu import dtypes as jdt
    rng = np.random.default_rng(16)
    r, ub, v = 3, 256, 64
    unc = rng.integers(0, 256, (r, ub), dtype=np.uint8)
    voff = np.array([0, 7, 201], np.int32)
    nn = rng.integers(-1, 40, (r, v)).astype(np.int32)
    jt = jdt.INT32 if dtype == "int32" else jdt.FLOAT64
    want = jpd._plain_gather(jnp.asarray(unc), jnp.asarray(voff),
                             jnp.asarray(nn), jt)
    size = 4 if dtype == "int32" else 8
    got = pqk.plain_gather(torch.from_numpy(unc), torch.from_numpy(voff),
                           torch.from_numpy(nn), size)
    np.testing.assert_array_equal(_np(want).view(np.uint8),
                                  got.numpy().view(np.uint8))


def _snappy_planes(golden):
    """Page planes of real snappy pages (literal-only and copy-bearing)
    plus torn rows (``chip_smoke.snappy_torn_set``, W1's torn set on the
    card): random bytes, a truncated compressed length, a page cut short,
    a literal that leaves the kernel's window and a chain of literals that
    each leave it."""
    return chip_smoke.snappy_torn_set(golden / "copies.parquet", CPU)


def test_w1_plain_matches_snappy_pass1(golden):
    comp, clen, ulen, g = _snappy_planes(golden)
    ub, tb = g.ub, g.tb
    walk = jax.jit(jax.vmap(jpd._snappy_pass1, in_axes=(0, 0, 0, None, None)),
                   static_argnums=(3, 4))
    want = walk(jnp.asarray(comp), jnp.asarray(clen), jnp.asarray(ulen), ub,
                tb)
    dk, ls, co = pqk.snappy_walk(torch.from_numpy(comp),
                                 torch.from_numpy(clen),
                                 torch.from_numpy(ulen), ub, tb)
    got = (pqk.scatter_drop(ub, -1, dk, dk), pqk.scatter_drop(ub, 0, dk, ls),
           pqk.scatter_drop(ub, 0, dk, co))
    for w, x in zip(want, got):
        np.testing.assert_array_equal(_np(w), x.numpy())
    assert comp.shape[1] > 2048  # pages longer than the kernel's window
    # the literal row leaves the window at its first token
    assert int(ls[-2, 0]) == 5 and int(dk[-2, 1]) == 3000
    # the chain row: 3-byte preamble, three 10-byte literals, 40 literals of
    # 2,100 bytes, five 8-byte copies, 3 more long literals, two short ones
    assert int(ls[-1, 3]) == 3 + 3 * 11 + 3
    assert int(dk[-1, 52]) == 30 + 43 * 2100 + 5 * 8 + 10
    assert int(dk[-1, 53]) == ub
    # and the whole decompression, chase included
    dec = jax.jit(jpd._snappy_decompress, static_argnums=(3, 4, 5))
    np.testing.assert_array_equal(
        _np(dec(jnp.asarray(comp), jnp.asarray(clen), jnp.asarray(ulen), ub,
                True, tb)),
        ppd._snappy_decompress(torch.from_numpy(comp),
                               torch.from_numpy(clen),
                               torch.from_numpy(ulen), ub, True, tb).numpy())


def test_w2_plain_matches_hybrid_pass1():
    """Real hybrid streams (RLE and bit-packed runs, def levels and
    dictionary indices) and torn ones (random bytes, zero-count headers,
    runs past the value count)."""
    rng = np.random.default_rng(18)
    vb, ub = 256, 512
    rows, start, end, bw, n = [], [], [], [], []
    for width, count in ((1, 200), (5, 256), (11, 130)):
        vals = rng.integers(0, 1 << width, count)
        vals[40:90] = vals[40]  # a long RLE run
        enc = np.frombuffer(chip_smoke.rle_hybrid_encode(vals, width),
                            np.uint8)
        row = np.zeros(ub, np.uint8)
        row[3:3 + len(enc)] = enc
        rows.append(row)
        start.append(3)
        end.append(3 + len(enc))
        bw.append(width)
        n.append(count)
    for width in (1, 7, 32):
        rows.append(rng.integers(0, 256, ub, dtype=np.uint8))
        start.append(int(rng.integers(0, 8)))
        end.append(ub)
        bw.append(width)
        n.append(vb)
    zero = np.zeros(ub, np.uint8)  # zero-count RLE headers: still advance
    rows.append(zero)
    start.append(0)
    end.append(40)
    bw.append(3)
    n.append(vb)
    args = [np.stack(rows)] + [np.asarray(x, np.int32)
                               for x in (start, end, bw, n)]
    walk = jax.jit(jax.vmap(jpd._hybrid_pass1, in_axes=(0, 0, 0, 0, 0, None)),
                   static_argnums=5)
    want = walk(*[jnp.asarray(a) for a in args], vb)
    got = pqk.hybrid_walk_plain(*[torch.from_numpy(a) for a in args], vb)
    for w, x in zip(want, got):  # rv: u32 in JAX, its bits in int32 here
        w = _np(w)
        np.testing.assert_array_equal(w.view(x.numpy().dtype), x.numpy())
    rle = jax.jit(jpd._rle_hybrid, static_argnums=5)
    np.testing.assert_array_equal(
        _np(rle(*[jnp.asarray(a) for a in args], vb)).astype(np.int64),
        ppd._rle_hybrid(*[torch.from_numpy(a) for a in args], vb).numpy())


def test_kernel_wrappers_check_inputs():
    unc = torch.zeros((2, 16), dtype=torch.uint8)
    with pytest.raises(ValueError):
        pqk.plain_gather(unc, torch.zeros(2, dtype=torch.int32),
                         torch.zeros((2, 4), dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        pqk.plain_gather(unc, torch.zeros(3, dtype=torch.int32),
                         torch.zeros((2, 4), dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        pqk.snappy_walk(unc, torch.zeros(2, dtype=torch.int64),
                        torch.zeros(2, dtype=torch.int32), 16, 16)


# -- edges ------------------------------------------------------------------

def test_truncated_page_raises_typed_error(tmp_path):
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"x": pa.array(range(500), pa.int64())}), path,
                   compression="snappy", use_dictionary=False)
    pf = ppq.ParquetFile(path)
    pf.row_groups[0].chunks[0].total_compressed = 5
    with pytest.raises(ppq.TruncatedPageError):
        ppq.plan_device_group(pf, 0, None, 1 << 30, CPU)
    assert issubclass(ppq.TruncatedPageError, TransientError)
    assert issubclass(ppq.TruncatedPageError, OSError)


def test_fallback_reasons_match_jax(tmp_path):
    cases = {
        "strings": (pa.table({"s": pa.array(["a", "bb", None])}), {},
                    "physical_type"),
        "nested": (pa.table({"l": pa.array([[1], [2, 3], None])}), {},
                   "nested"),
        "zstd": (pa.table({"x": pa.array(range(500), pa.int64())}),
                 {"compression": "zstd"}, "codec"),
        "v2": (pa.table({"x": pa.array(range(500), pa.int64())}),
               {"data_page_version": "2.0"}, "v2_pages"),
        "narrowed": (pa.table({"x": pa.array(range(50), pa.int16())}), {},
                     "narrowed_type"),
    }
    for name, (table, kw, want) in cases.items():
        path = tmp_path / f"{name}.parquet"
        pq.write_table(table, path, **kw)
        jc, pc = plan_both(path, 0)
        _, reason = ppq.plan_device_group(ppq.ParquetFile(path), 0, None,
                                          1 << 30, CPU)
        assert jc is None and pc is None and reason == want, (name, reason)
    big = tmp_path / "zstd.parquet"
    _, reason = ppq.plan_device_group(ppq.ParquetFile(big), 0, None, 10, CPU)
    assert reason == "codec"
    path = tmp_path / "big.parquet"
    pq.write_table(pa.table({"x": pa.array(range(5000), pa.int64())}), path)
    _, reason = ppq.plan_device_group(ppq.ParquetFile(path), 0, None, 1000,
                                      CPU)
    assert reason == "oversized_group"


def test_iter_device_mixes_routes(tmp_path):
    """A file with a STRING column falls back group by group with its
    reason, in group order; device groups decode to the host route's rows."""
    rng = np.random.default_rng(19)
    n = 3000
    path = tmp_path / "m.parquet"
    pq.write_table(pa.table({"k": pa.array(rng.integers(0, 99, n),
                                           pa.int64()),
                             "v": _column(rng, "float64", "sparse", n)}),
                   path, row_group_size=1000, compression="snappy",
                   use_dictionary=False)
    reader = ppq.ParquetChunkedReader(path, device=CPU, prefetch=2)
    host = list(ppq.ParquetChunkedReader(path, device=CPU))
    items = list(reader.iter_device())
    assert [k for k, _, _ in items] == ["dev"] * 3
    for (_, chunk, _), want in zip(items, host):
        got = ppd.decode_table(chunk.to_device(CPU), chunk.geom)
        for a, b in zip(got.columns, want.columns):
            np.testing.assert_array_equal(
                a.data[:chunk.nrows].numpy().view(np.uint8),
                b.data.numpy().view(np.uint8))
    spath = tmp_path / "s.parquet"
    pq.write_table(pa.table({"s": pa.array(["x"] * 10)}), spath)
    (kind, (table, nrows), reason), = list(
        ppq.ParquetChunkedReader(spath, device=CPU).iter_device())
    assert (kind, reason, nrows, table.num_rows) == \
        ("host", "physical_type", 10, 10)


def test_zero_planes_decode_to_empty_rows(golden):
    """All-zero planes (a zero page decodes to no rows) and the 1-row probe
    table carry the decode output's schema."""
    chunk, _ = ppq.plan_device_group(ppq.ParquetFile(golden / "p.parquet"),
                                     0, None, 1 << 30, CPU)
    table = ppd.decode_table(ppd.zero_planes(chunk.geom, CPU), chunk.geom)
    probe = ppd.probe_table(chunk.geom, CPU)
    assert table.names == probe.names
    for c, p in zip(table.columns, probe.columns):
        assert c.dtype == p.dtype and c.data.dtype == p.data.dtype
        assert not c.data.view(torch.uint8).any()
        assert not c.validity.any() and p.validity.all()



@pytest.mark.parametrize("entry", [
    "read_parquet", "ParquetChunkedReader", "plan_device_group", "to_device",
    "probe_table", "zero_planes", "from_pydict", "inner_join"])
def test_scan_entry_points_default_to_cuda(golden, entry):
    """The scan path's entry points, called without ``device=``, run on
    CUDA; where torch sees no card they raise instead of returning CPU
    tensors."""
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.ops import join
    path = golden / "p.parquet"
    pf = ppq.ParquetFile(path)
    chunk, _ = ppq.plan_device_group(pf, 0, None, 1 << 30, CPU)
    t = Table.from_pydict({"k": [1, 2]}, device=CPU)
    call = {
        "read_parquet": lambda: ppq.read_parquet(path).columns[0].data,
        "ParquetChunkedReader":
            lambda: next(iter(ppq.ParquetChunkedReader(path))).columns[0].data,
        "plan_device_group":
            lambda: ppq.plan_device_group(pf, 0, None, None)[0].to_device(
                "cuda")[chunk.geom.columns[0].name]["comp"],
        "to_device":
            lambda: chunk.to_device()[chunk.geom.columns[0].name]["comp"],
        "probe_table": lambda: ppd.probe_table(chunk.geom).columns[0].data,
        "zero_planes": lambda: ppd.zero_planes(chunk.geom)[
            chunk.geom.columns[0].name]["comp"],
        "from_pydict": lambda: Table.from_pydict({"k": [1]}).columns[0].data,
        "inner_join": lambda: join.inner_join(t, t, ["k"]).columns[0].data,
    }[entry]
    if torch.cuda.is_available():
        assert call().is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA"):
        call()

def test_port_never_imports_jax(tmp_path):
    """The scan path and chip_smoke.py import neither jax nor the JAX
    package (a fresh interpreter, so this file's own imports don't count)."""
    import subprocess
    import sys
    import textwrap
    from pathlib import Path
    path = tmp_path / "t.parquet"
    pq.write_table(pa.table({"x": pa.array(range(300), pa.int64()),
                             "s": pa.array(["a"] * 300)}), path)
    code = textwrap.dedent(f"""
        import sys
        import chip_smoke
        from spark_rapids_jni_tpu_torch.io import read_parquet
        from spark_rapids_jni_tpu_torch.io.parquet import (
            ParquetChunkedReader)
        from spark_rapids_jni_tpu_torch.ops import join, parquet_decode
        from spark_rapids_jni_tpu_torch.utils import errors
        t = read_parquet({str(path)!r}, device="cpu")
        join.left_semi_join(t, t, ["x"], device="cpu")
        r = ParquetChunkedReader({str(path)!r}, columns=["x"], device="cpu")
        for kind, chunk, _ in r.iter_device():
            parquet_decode.decode_table(chunk.to_device("cpu"), chunk.geom)
        bad = sorted(m for m in sys.modules if m == "jax"
                     or m.startswith("jax.") or m == "spark_rapids_jni_tpu"
                     or m.startswith("spark_rapids_jni_tpu."))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout
