"""The comparisons that decide ``correct``: each number beside its limit.

A served request is read by its last-position logits against the
reference's: the gap by which the served token's reference logit lies
below the reference's best, and the relative L2 distance of the two
logit vectors.  A training run is read by its checked steps' losses,
and at the worst leaf by the first step's clipped gradient (the gap of
its norm, and its distance, the norm of the difference) and by the
parameters' change after the checked steps (the gap of its norm), each
against the reference's norm of that leaf or of the median leaf, the
larger.  The sealed round trip is compared exactly in every cell; a
cell's file gives the limits of the readings it compares, and the
others are printed beside them.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional, Tuple

import torch

Numbers = Dict[str, Tuple[float, float]]
#: the limit of an exact comparison
EXACT = 0.0
#: a leaf whose reference gradient is under this share of the median
#: leaf's moves under Adam by round-off alone
MOVED_SHARE = 1e-3


def logit_numbers(logits: torch.Tensor, tokens: torch.Tensor,
                  ref: torch.Tensor) -> Tuple[List[float], List[float]]:
    """(n, V) logits of the side judged, the (n,) tokens it served, and
    the reference's (n, V) logits -> (each row's gap: the reference's best
    logit less its logit of the served token; each row's relative L2
    distance of the logits)."""
    logits, ref = logits.float(), ref.float()
    tok = tokens.to(device=ref.device, dtype=torch.long)[:, None]
    gap = ref.amax(dim=-1) - ref.gather(1, tok)[:, 0]
    rel = (logits - ref).norm(dim=-1) / ref.norm(dim=-1)
    return gap.tolist(), rel.tolist()


def leaf_gap(side: Dict[str, float], ref: Dict[str, float],
             keep: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """The worst leaf's |side - ref| of two per-leaf norms, over
    max(ref, median ref) -> (gap, leaf); ``keep`` limits the leaves."""
    names = sorted(ref) if keep is None else sorted(keep)
    return leaf_distance({k: abs(side[k] - ref[k]) for k in names}, ref)


def leaf_distance(dist: Dict[str, float], ref: Dict[str, float]
                  ) -> Tuple[float, str]:
    """The worst leaf of ``dist`` (a per-leaf distance: a gap of norms,
    or a norm of the difference) over max(ref, the median leaf's ref)
    -> (distance, leaf)."""
    med = statistics.median(ref[k] for k in sorted(ref))
    worst, at = 0.0, ""
    for k in sorted(dist):
        d = dist[k] / max(ref[k], med, 1e-30)
        if not math.isfinite(d):
            return math.inf, k
        if d > worst:
            worst, at = d, k
    return worst, at


def moved_leaves(ref_grads: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is at least
    :data:`MOVED_SHARE` of the median leaf's."""
    med = statistics.median(ref_grads.values())
    return [k for k, v in sorted(ref_grads.items())
            if v >= MOVED_SHARE * med]


def compared(readings: Dict[str, float], limits: Dict[str, float]
             ) -> Tuple[Numbers, Dict[str, float]]:
    """(each number a cell compares beside its limit, the readings it
    does not compare).  The sealed round trip is compared exactly in
    every cell; the others where the cell's file gives a limit."""
    limits = {"roundtrip_mismatches": EXACT, **limits}
    return ({k: (readings[k], lim) for k, lim in limits.items()},
            {k: v for k, v in readings.items() if k not in limits})


def passes(numbers: Numbers) -> bool:
    return all(math.isfinite(v) and v <= lim for v, lim in numbers.values())


def lines(numbers: Numbers) -> List[str]:
    return [f"check {k} = {v!r} limit {lim!r}"
            for k, (v, lim) in numbers.items()]


def as_json(numbers: Numbers) -> Dict[str, Dict[str, Optional[float]]]:
    """A number that is not finite (a failed comparison) is null."""
    return {k: {"value": v if math.isfinite(v) else None, "limit": lim}
            for k, (v, lim) in numbers.items()}
