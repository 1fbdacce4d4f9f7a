"""The histogram chunk of `lightgbm_tpu/ingest/landing.py`
`plan_row_layout` (:34-63, serial branch).

The port keeps no padded rows and grows trees one split at a time, so
the JAX package's row plan shapes none of its programs. One number of
it does reach a result: the quantize gate (`boosting/gbdt.py`
`_hist_quant_gate`) calibrates on the leading `chunk` rows, and
`tpu_hist_chunk` sets that chunk, capped by the group-block budget and
the row count.
"""
from __future__ import annotations

import numpy as np


def hist_chunk(n: int, num_groups: int, max_num_bin: int,
               tpu_hist_chunk: int = 65536) -> int:
    """The JAX plan's chunk: `tpu_hist_chunk` capped at 2^20, at the
    power of two under the group-block budget (16 << 26 one-hot
    elements, at least 8,192 rows) and at the power of two at or above
    n (at least 256)."""
    chunk = min(int(tpu_hist_chunk), 1 << 20)
    gb = max(1, int(num_groups) * int(max_num_bin))
    target = max(1, (16 << 26) // gb)
    chunk = min(chunk, max(8192, 1 << int(np.floor(np.log2(target)))))
    return int(min(chunk, max(256, 1 << int(np.ceil(np.log2(max(n, 1)))))))
