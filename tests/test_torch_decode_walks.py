"""W2 on its torn set, against the JAX package, on the CPU.

The torn set is ``chip_smoke.hybrid_torn_set``: the same seeded inputs on
which ``chip_smoke.py`` holds the CUDA kernel against its plain version on
the card.  Here the port's wrapper gets CPU tensors and takes its plain
version, which must equal the JAX package's ``_rle_hybrid`` bit for bit.
The one row where the port's ``it < n`` bound ends a walk that the JAX
loop would carry on for ~2^30 steps is held against its values worked out
by hand.  (W1's torn set, ``chip_smoke.snappy_torn_set``, is held against
``_snappy_pass1`` in ``test_torch_parquet_decode.py``.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from spark_rapids_jni_tpu.ops import parquet_decode as jpd
from spark_rapids_jni_tpu_torch.kernels import parquet_decode as pqk

torch.set_num_threads(1)
TORN = chip_smoke.hybrid_torn_set(0)
LABELS, VB, JAX_OK = TORN[0], TORN[6], TORN[7]
_rle = jax.jit(jpd._rle_hybrid, static_argnums=5)


def _row(i):
    """Row ``i`` of the hybrid torn set: (data, start, end, bw, n)."""
    return [a[i:i + 1] for a in TORN[1:6]]


@pytest.mark.parametrize("i", [i for i, ok in enumerate(JAX_OK) if ok],
                         ids=lambda i: LABELS[i])
def test_hybrid_decode_matches_rle_hybrid(i):
    args = _row(i)
    want = np.asarray(_rle(*[jnp.asarray(a) for a in args], VB))
    got = pqk.hybrid_decode(*[torch.from_numpy(a) for a in args], VB)
    assert got.dtype == torch.int64 and got.shape == (1, VB)
    np.testing.assert_array_equal(want.astype(np.int64), got.numpy())


def test_hybrid_decode_it_n_row():
    """Two RLE runs of 100 (7s, then 9s), then a packed header whose count
    wraps v and whose payload sends s to -2^31 + 4: the remaining 8,189
    steps (the ``it < n`` bound) read row[0] = 2 as one-value runs of 2 at
    negative counts, which all land on slot 0 and unmark it.  Slots 0-99
    take slot 0's last entry (2), 100-199 the 9s, and 200 on the packed
    run's bits: the zero bytes after the stream."""
    i = LABELS.index("it < n bound (value count and position wrap)")
    assert not JAX_OK[i] and not any(
        not ok for j, ok in enumerate(JAX_OK) if j != i)
    got = pqk.hybrid_decode(*[torch.from_numpy(a) for a in _row(i)], VB)
    want = np.zeros(VB, np.int64)
    want[:100], want[100:200] = 2, 9
    np.testing.assert_array_equal(got[0].numpy(), want)


def _bad_hybrid_args(case):
    data = torch.zeros((2, 64), dtype=torch.uint8)
    i32 = torch.zeros(2, dtype=torch.int32)
    args = {"data": data, "start": i32, "end": i32, "bw": i32, "n": i32,
            "vb": 16}
    if case == "int64 start":
        args["start"] = i32.to(torch.int64)
    elif case == "int8 data":
        args["data"] = data.to(torch.int8)
    elif case == "2-D n":
        args["n"] = i32[:, None]
    elif case == "rows disagree":
        args["bw"] = torch.zeros(3, dtype=torch.int32)
    elif case == "1-D data":
        args["data"] = data[0]
    elif case == "strided data":
        args["data"] = torch.zeros((2, 128), dtype=torch.uint8)[:, ::2]
    elif case == "no slots":
        args["vb"] = 0
    elif case == "empty rows":
        args["data"] = torch.zeros((2, 0), dtype=torch.uint8)
    return args


@pytest.mark.parametrize("case", [
    "int64 start", "int8 data", "2-D n", "rows disagree", "1-D data",
    "strided data", "no slots", "empty rows"])
def test_hybrid_decode_rejects_bad_inputs(case):
    a = _bad_hybrid_args(case)
    with pytest.raises(ValueError):
        pqk.hybrid_decode(a["data"], a["start"], a["end"], a["bw"], a["n"],
                          a["vb"])
