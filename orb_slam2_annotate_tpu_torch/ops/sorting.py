"""Order statistics with the reference's tie and NaN semantics.

``lax.top_k`` puts the lowest index first among equal values, while
``torch.topk`` guarantees no order among ties; scores on the SLAM path are
mostly 0/1 or small integers, so ties are the normal case.  Every top-k of
the port goes through ``stable_topk``.  ``jnp.nanmedian`` averages the two
middle values, while ``torch.nanmedian`` returns the lower one.
"""

from __future__ import annotations

import torch


def stable_topk(x: torch.Tensor, k: int, dim: int = -1):
    """(values, indices) of the k largest along `dim`, lowest index first
    among ties (``lax.top_k`` order)."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def nanmedian(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Median ignoring NaNs, the mean of the two middle values for an even
    count (``jnp.nanmedian``); NaN where every entry is NaN."""
    s = torch.sort(x, dim=dim).values              # NaNs sort last
    n = (~torch.isnan(x)).sum(dim=dim, keepdim=True)
    q = 0.5 * (n - 1).to(x.dtype)
    last = torch.clamp_min(n - 1, 0)
    lo = torch.minimum(torch.clamp_min(torch.floor(q).long(), 0), last)
    hi = torch.minimum(torch.clamp_min(torch.ceil(q).long(), 0), last)
    out = (torch.gather(s, dim, lo) + torch.gather(s, dim, hi)) * 0.5
    return out.squeeze(dim)
