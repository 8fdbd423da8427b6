"""Piecewise-constant 1D distribution: CDF built on the host, queried with
``torch.searchsorted`` on the device (port of utils/distribution.py)."""

import numpy as np
import torch


class Distribution1D:
    """CDF table over n weights; queries are batched over u."""

    def __init__(self, weights, device):
        f = np.asarray(weights, np.float32)
        n = len(f)
        cdf = np.zeros(n + 1, np.float64)
        np.cumsum(f / n, out=cdf[1:])
        func_int = cdf[-1]
        if func_int == 0.0:
            cdf[:] = np.arange(n + 1) / n
        else:
            cdf /= func_int
        self.count = n
        self.func_int = float(func_int)
        self.func = torch.as_tensor(f, device=device)
        self.cdf = torch.as_tensor(cdf.astype(np.float32), device=device)

    def to(self, device):
        """A copy with its tables on device."""
        out = object.__new__(Distribution1D)
        out.__dict__.update(self.__dict__, func=self.func.to(device),
                            cdf=self.cdf.to(device))
        return out

    def sample_discrete(self, u):
        """Index with probability func[i]/(funcInt*n); returns (idx, pmf)."""
        idx = torch.searchsorted(self.cdf, u.contiguous(), right=True) - 1
        idx = torch.clamp(idx, 0, self.count - 1)
        return idx, self.pmf(idx)

    def pmf(self, idx):
        return self.func[idx] / np.float32(max(self.func_int * self.count,
                                              1e-30))
