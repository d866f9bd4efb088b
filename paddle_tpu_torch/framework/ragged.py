"""RaggedTensor, the host container of a 1-level ragged batch (port of
``paddle_tpu/framework/ragged.py``, which stands in for the reference's
LoDTensor, ``paddle/fluid/framework/lod_tensor.h:109``).

``values`` flattened along dim 0 with ``row_splits`` offsets, exactly a
1-level LoD, for the data pipeline; on the device the sequence ops
(``ops/sequence.py``) take a padded ``[batch, maxlen, ...]`` tensor and
an int32 ``lengths [batch]`` instead, and :meth:`RaggedTensor.to_padded`
/ :meth:`RaggedTensor.from_padded` convert explicitly. Pure numpy: a
tensor on the card passed to :meth:`from_padded` or :meth:`from_rows`
is copied to the host first.
"""


from __future__ import annotations

import numpy as np

__all__ = ["RaggedTensor"]


def _host(x):
    """``x`` as a numpy array (a torch tensor, on any device, copied to
    the host)."""
    if hasattr(x, "detach") and hasattr(x, "cpu"):
        return x.detach().cpu().numpy()
    if hasattr(x, "numpy") and not isinstance(x, np.ndarray):
        return np.asarray(x.numpy())
    return np.asarray(x)


class RaggedTensor:
    """1-level ragged batch: ``values`` flattened along dim 0, row i owning
    ``values[row_splits[i]:row_splits[i+1]]``."""

    def __init__(self, values, row_splits):
        self.values = np.asarray(values)
        self.row_splits = np.asarray(row_splits, dtype=np.int64)
        if self.row_splits.ndim != 1 or self.row_splits[0] != 0:
            raise ValueError("row_splits must be 1-D starting at 0")
        if int(self.row_splits[-1]) != self.values.shape[0]:
            raise ValueError(
                f"row_splits end {int(self.row_splits[-1])} != "
                f"values rows {self.values.shape[0]}")

    # -- constructors -------------------------------------------------
    @staticmethod
    def from_rows(rows):
        rows = [_host(r) for r in rows]
        splits = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum([r.shape[0] for r in rows], out=splits[1:])
        values = (np.concatenate(rows, axis=0) if rows
                  else np.zeros((0,), dtype=np.float32))
        return RaggedTensor(values, splits)

    @staticmethod
    def from_padded(padded, lengths):
        padded = _host(padded)
        lengths = _host(lengths).astype(np.int64)
        return RaggedTensor.from_rows(
            [padded[i, : int(n)] for i, n in enumerate(lengths)])

    # -- views --------------------------------------------------------
    @property
    def lengths(self):
        return np.diff(self.row_splits)

    @property
    def nrows(self):
        return len(self.row_splits) - 1

    def row(self, i):
        return self.values[self.row_splits[i]:self.row_splits[i + 1]]

    def rows(self):
        return [self.row(i) for i in range(self.nrows)]

    def __len__(self):
        return self.nrows

    def __repr__(self):
        return (f"RaggedTensor(nrows={self.nrows}, "
                f"values={self.values.shape}, dtype={self.values.dtype})")

    # -- device bridge ------------------------------------------------
    def to_padded(self, maxlen=None, pad_value=0):
        """Return ``(padded [nrows, maxlen, ...], lengths [nrows])`` — the
        static-shape device representation."""
        lengths = self.lengths
        m = int(maxlen) if maxlen is not None else int(lengths.max(initial=0))
        tail = self.values.shape[1:]
        out = np.full((self.nrows, m) + tail, pad_value,
                      dtype=self.values.dtype)
        for i in range(self.nrows):
            n = min(int(lengths[i]), m)
            out[i, :n] = self.row(i)[:n]
        return out, np.minimum(lengths, m).astype(np.int32)

    def concat(self, other):
        return RaggedTensor.from_rows(self.rows() + other.rows())
