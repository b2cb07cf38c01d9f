"""String predicates over Arrow-layout STRING columns.

The port of ``spark_rapids_jni_tpu/ops/strings.py``, so far only ``equal``:
the kernel the engine lowers ``==``/``!=`` filter predicates over STRING
columns onto.  The compute form is the padded byte matrix
(``strings_common.to_padded_bytes``); results are BOOL8 columns.  The rest
of the module comes with NDS-lite.
"""

from __future__ import annotations

import numpy as np
import torch

from ..columnar import Column
from ..dtypes import BOOL8
from .strings_common import to_padded_bytes


def _literal(pat) -> bytes:
    return pat.encode() if isinstance(pat, str) else bytes(pat)


def _prop_valid(col: Column, extra=None):
    v = col.validity
    if extra is not None:
        v = extra if v is None else (v & extra)
    return v


def equal(col: Column, other) -> Column:
    """Elementwise ``==`` against a Python string or another STRING column
    (raw ``col.data`` is a chars buffer, so a plain tensor comparison is
    meaningless for strings)."""
    mat, lengths = to_padded_bytes(col)
    if isinstance(other, Column):
        omat, olengths = to_padded_bytes(other)
        w = max(mat.shape[1], omat.shape[1])
        mat = torch.nn.functional.pad(mat, (0, w - mat.shape[1]))
        omat = torch.nn.functional.pad(omat, (0, w - omat.shape[1]))
        hit = (lengths == olengths) & (mat == omat).all(dim=1)
        return Column(BOOL8, data=hit.to(torch.uint8),
                      validity=_prop_valid(col, other.validity))
    pat = _literal(other)
    if len(pat) == 0:
        hit = lengths == 0
    elif len(pat) > mat.shape[1]:
        hit = torch.zeros(col.size, dtype=torch.bool, device=mat.device)
    else:
        target = torch.from_numpy(np.frombuffer(pat, np.uint8).copy()) \
            .to(mat.device)
        hit = (lengths == len(pat)) & (mat[:, :len(pat)] == target).all(dim=1)
    return Column(BOOL8, data=hit.to(torch.uint8), validity=_prop_valid(col))
