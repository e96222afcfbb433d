"""Senone-sharded scoring: the counterpart of the reference dry run's `mp`
mesh axis.

The reference lays the senone axis of the mixture weights over the `mp`
axis of a `dp x mp` mesh and leaves the split of the scorer to GSPMD
(`__graft_entry__.py`, its decode check).  Here each of the `mp` ranks of
a group holds one contiguous senone range `[lo, hi)` of the model and
scores only it, through the scorer's own `senones(lo, hi)`
(`ops/gmm.py`):

- `ContinuousScorer`: lin, quad and const `[lo:hi]`, so K1 packs and
  scores the shard's senones alone;
- `PsParityScorer`: mixw `[:, :, lo:hi]`; the densities, their top-N and
  the normaliser are per codebook, so every rank computes them whole, and
  the shard's integer scores are the unsharded scorer's columns.

One `all_gather` in the group makes the `[..., T, S]` scores.  Shard r
holds senones `[r*w, min((r+1)*w, S))` with `w = ceil(S/mp)`; the last
one is padded to w columns for the gather, and the pad is cut after it.
The gather is rank-major, `[mp*N, w]`; `_join` makes it `[N, mp*w]`
before the cut.

`score_shards` scores the mp shards in turn in one process and joins
them the same way (`score_parts`): it is what one card and the CPU tests
hold bit for bit against the unsharded scorer.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


def shard_range(n_sen: int, mp: int, r: int) -> Tuple[int, int]:
    """Senones [lo, hi) of shard r of mp."""
    w = -(-n_sen // mp)
    if (mp - 1) * w >= n_sen:
        raise ValueError(f"{n_sen} senones do not fill {mp} shards of {w}")
    return r * w, min((r + 1) * w, n_sen)


def _pad(part: torch.Tensor, width: int) -> torch.Tensor:
    """[..., T, n] scores -> [N, width], the pad columns zero."""
    flat = part.reshape(-1, part.shape[-1])
    return F.pad(flat, (0, width - flat.shape[1])).contiguous()


def _join(gathered: torch.Tensor, mp: int, n_sen: int) -> torch.Tensor:
    """Rank-major [mp*N, w] -> [N, n_sen]: the shards side by side, the
    last one's pad cut."""
    w = gathered.shape[1]
    return (gathered.view(mp, -1, w).permute(1, 0, 2).reshape(-1, mp * w)
            [:, :n_sen])


def shards(scorer: nn.Module, mp: int) -> List[nn.Module]:
    """The mp shard scorers of `scorer`, in rank order."""
    return [scorer.senones(*shard_range(scorer.n_sen, mp, r))
            for r in range(mp)]


def score_parts(parts: List[nn.Module], feats: torch.Tensor
                ) -> torch.Tensor:
    """feats [..., T, D] -> [..., T, S]: the shard scorers `parts` (from
    `shards`) scored in turn in this process and joined as the group's
    gather joins them."""
    n_sen, w = sum(p.n_sen for p in parts), parts[0].n_sen
    out = torch.cat([_pad(p.score(feats), w) for p in parts])
    return _join(out, len(parts), n_sen).reshape(*feats.shape[:-1], n_sen)


def score_shards(scorer: nn.Module, feats: torch.Tensor, mp: int
                 ) -> torch.Tensor:
    """feats [..., T, D] -> [..., T, S]: the mp shards of `scorer` scored
    in turn in this process and joined as the group's gather joins
    them."""
    return score_parts(shards(scorer, mp), feats)


class SenoneShardedScorer(nn.Module):
    """Rank `mp_rank` of an `mp` group (`group`, from `dist.new_group`)
    holds shard `mp_rank` of `scorer`, on its device; `score` scores it and
    gathers the whole `[..., T, S]` over the group.  Every rank of the
    group must call `score` on features of the same shape."""

    def __init__(self, scorer: nn.Module, group, mp_rank: int, mp: int):
        super().__init__()
        self.n_sen, self.mp, self.group = scorer.n_sen, mp, group
        self.lo, self.hi = shard_range(self.n_sen, mp, mp_rank)
        self.width = -(-self.n_sen // mp)
        self.shard = scorer.senones(self.lo, self.hi)

    def score(self, feats: torch.Tensor) -> torch.Tensor:
        mine = _pad(self.shard.score(feats), self.width)
        out = mine.new_empty((self.mp * mine.shape[0], self.width))
        dist.all_gather_into_tensor(out, mine, group=self.group)
        return _join(out, self.mp, self.n_sen).reshape(
            *feats.shape[:-1], self.n_sen)

    forward = score
