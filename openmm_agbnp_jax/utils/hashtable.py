"""Open-addressing hash table (reference AGBNPHtable parity).

The reference implements a power-of-two open-addressing hash as the
prototype for its on-device radius-type lookup (reference
openmmapi/include/AGBNPUtils.h:19-96; device side AGBNPBornRadii.cl:14-29).
The device compute path replaces it with dense per-atom type-index arrays (no
hashing needed under static shapes), but the structure is provided for
API/test parity and for host-side tooling.
"""

from __future__ import annotations

import numpy as np


class AGBNPHtable:
    """Maps positive int values to slots: k = value & mask, linear jump probe."""

    def __init__(self, size: int, jump: int = 1):
        self.hsize = self._two2n_size(size)
        self.hmask = self.hsize - 1
        self.hjump = jump
        self.nvalues = 0
        self.values = np.full(self.hsize, -1, dtype=np.int64)

    @staticmethod
    def _two2n_size(m: int) -> int:
        if m <= 0:
            return 0
        s = 1
        while s < m:
            s <<= 1
        return s

    def h_enter(self, value: int) -> int:
        if self.nvalues >= self.hsize:
            return -1
        k = value & self.hmask
        while self.values[k] >= 0 and self.values[k] != value:
            k = (k + self.hjump) & self.hmask
        self.values[k] = value
        self.nvalues += 1
        return int(k)

    def h_find(self, value: int) -> int:
        k = value & self.hmask
        ntries = 0
        while (self.values[k] >= 0 and self.values[k] != value
               and ntries < self.hsize):
            k = (k + self.hjump) & self.hmask
            ntries += 1
        if self.values[k] < 0 or ntries >= self.hsize:
            return -1
        return int(k)

    def size(self) -> int:
        return self.hsize
