"""GPipe-style pipeline parallelism with AEAD-sealed stage boundaries.

Port of ``repro/dist/pipeline_parallel.py``.  The paper encrypts every
inter-worker stream; for model pipeline parallelism the wire is the
activation crossing a stage boundary.  ``pipeline_apply`` runs the classic
GPipe schedule — S stages, M microbatches, M+S-1 ticks, microbatch m
entering stage s at tick m+s — and seals every stage->stage hand-off with
:func:`repro_torch.core.secure_channel.protect_many` (ChaCha20-CTR +
CW-MAC), so a tampered activation is detected at the receiving stage.

Stages execute in tick order in one process on one device, which is the
reference's schedule, exact on any device count.  Keys come from a
:class:`repro_torch.attest.KeyDirectory` (:func:`edge_directory`): each
stage boundary is an attested handshake session, and ``rekey_every_n``
ratchets every edge key mid-schedule (hand-offs sealed before a flip
drain under their sealing epoch).

Every hand-off of a tick is sealed by ONE ``protect_many`` call a shape
group (per-edge keys batched: one cipher-pass launch and one CW-MAC
launch on the card), and every sealed inflow of the next tick is opened
by one ``unprotect_many`` a shape group.  The verdicts of a group reach
the host in ONE sync (the reference syncs once an item), and the error
names the same first failing (stage, microbatch).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.attest.directory import KeyDirectory
from repro_torch.attest.measure import measure_bytes
from repro_torch.core.secure_channel import protect_many, unprotect_many
from repro_torch.crypto.keys import StageKey


class PipelineMACError(RuntimeError):
    """A sealed stage-boundary activation failed its MAC check."""


def gpipe_schedule(num_stages: int,
                   num_microbatches: int) -> List[List[Tuple[int, int]]]:
    """The GPipe tick table: ``ticks[t]`` lists active ``(stage, mb)``.

    M + S - 1 ticks; microbatch m occupies stage s at tick m + s.  The
    bubble fraction is the classic (S-1)/(M+S-1).
    """
    S, M = num_stages, num_microbatches
    return [[(s, t - s) for s in range(S) if 0 <= t - s < M]
            for t in range(M + S - 1)]


def edge_directory(num_stages: int, *, seed: int = 0,
                   label: str = "pp") -> KeyDirectory:
    """A KeyDirectory with one attested session per stage boundary.

    Each stage endpoint is enrolled under a measurement of its position in
    the chain and edge ``{label}-edge{s}`` (into stage s, s >= 1) is
    established by the quote-checked handshake — the paper's "key
    establishment was previously performed", actually performed.
    """
    d = KeyDirectory(seed=seed)
    for s in range(num_stages):
        m = measure_bytes(b"pp-stage", label.encode(), str(s).encode())
        d.enroll(f"{label}/stage{s}", m, allow=True)
    for s in range(1, num_stages):
        d.establish(f"{label}-edge{s}", f"{label}/stage{s - 1}",
                    f"{label}/stage{s}", stage_id=s)
    return d


# pipeline_apply's default directories, one per (S, seed, label): the
# handshakes are a control-plane cost that must not recur on every
# invocation of a per-step schedule.  Callers who rekey should pass their
# own directory — epoch state on a shared default would leak across
# unrelated callers.
_DEFAULT_DIRS: dict = {}


def _default_edge_directory(num_stages: int, seed: int,
                            label: str) -> KeyDirectory:
    ck = (num_stages, seed, label)
    d = _DEFAULT_DIRS.get(ck)
    if d is None:
        d = _DEFAULT_DIRS[ck] = edge_directory(num_stages, seed=seed,
                                               label=label)
    return d


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_weights: torch.Tensor,
                   microbatches: torch.Tensor,
                   mesh=None, *,
                   axis: str = "stage",
                   seal: bool = True,
                   key_seed: int = 0,
                   step: int = 0,
                   directory: Optional[KeyDirectory] = None,
                   rekey_every_n: Optional[int] = None,
                   key_label: str = "pp") -> torch.Tensor:
    """Apply an S-stage pipeline to M microbatches on the GPipe schedule.

    ``stage_weights``: (S, ...) — stage s computes
    ``stage_fn(stage_weights[s], x)``.  ``microbatches``: (M, ...) enter
    stage 0 in order; returns the (M, ...) stack of stage S-1 outputs,
    bitwise equal to sequentially chaining the stages per microbatch
    (sealing is an exact XOR-stream roundtrip).

    Edge keys come from a ``repro_torch.attest.KeyDirectory``
    (``directory``, or a cached :func:`edge_directory` seeded by
    ``key_seed``), one attested session per boundary.  ``rekey_every_n``
    ratchets every edge key after each N ticks, mid-schedule: a hand-off
    sealed in epoch E is opened with the epoch-E key one tick later even
    if the flip happened in between (old epoch drains, new epoch seals).

    Edge counters are ``step * M + microbatch``: a caller invoking this
    repeatedly under the same directory/seed (e.g. once per training
    step) MUST pass a distinct ``step`` each time, or every invocation
    reuses the per-edge (key, nonce) pairs — a two-time pad on the
    activations.

    When ``mesh`` (a :class:`repro_torch.dist.meshctx.Mesh`) carries an
    ``axis`` axis of size > 1 it must equal S (one stage per worker).
    """
    S = int(stage_weights.shape[0])
    M = int(microbatches.shape[0])
    if mesh is not None and axis in mesh.shape:
        n = int(mesh.shape[axis])
        if n > 1 and n != S:
            raise ValueError(
                f"mesh axis {axis!r} has size {n} but there are {S} stages")
    d = None
    if seal and S > 1:
        d = directory if directory is not None else \
            _default_edge_directory(S, key_seed, key_label)
        if directory is None and rekey_every_n:
            raise ValueError(
                "rekey_every_n mutates the directory's epoch state; pass "
                "an explicit directory= (edge_directory(...)) instead of "
                "sharing the cached default")

    def _edge_key(s: int, epoch: Optional[int] = None) -> StageKey:
        return d.edge_key(f"{key_label}-edge{s}", epoch=epoch)

    outs: List[Optional[torch.Tensor]] = [None] * M
    # inflight[s]: the (sealed) activation entering stage s next tick;
    # sealed entries are (ct, tag, meta, epoch-at-seal).
    inflight: dict = {}
    for t, tick in enumerate(gpipe_schedule(S, M)):
        # open every sealed inflow of this tick in ONE batched call a
        # shape group (shape-preserving stage_fns — the common case —
        # yield a single group per tick).  Per-item keys are resolved at
        # each entry's sealing epoch, so one batch may mix epochs across
        # a rekey boundary.
        opened: dict = {}
        if seal:
            groups: dict = {}
            for s, mb in tick:
                if s > 0:
                    ct, _, meta, _ = inflight[s]
                    groups.setdefault((tuple(ct.shape), meta),
                                      []).append((s, mb))
            for (_, meta), members in groups.items():
                cts = torch.stack([inflight[s][0] for s, _ in members])
                tags = torch.stack([inflight[s][1] for s, _ in members])
                xs, oks = unprotect_many(
                    [_edge_key(s, inflight[s][3]) for s, _ in members],
                    [step * M + mb for _, mb in members], cts, tags, meta)
                # one host sync a group; the first failing item in member
                # order is the one the reference's per-item check names
                for i, ok in enumerate(oks.tolist()):
                    s, mb = members[i]
                    if not ok:
                        raise PipelineMACError(
                            f"MAC failure on edge into stage {s}, "
                            f"microbatch {mb}")
                    opened[s] = xs[i]

        sends: List[Tuple[int, int, torch.Tensor]] = []  # (stage, mb, act)
        for s, mb in tick:
            if s == 0:
                x = microbatches[mb]
            elif seal:
                x = opened[s]
            else:
                x = inflight[s]
            y = stage_fn(stage_weights[s], x)
            if s == S - 1:
                outs[mb] = y
            else:
                sends.append((s + 1, mb, y))

        # seal every hand-off of this tick in ONE batched call per
        # activation shape (one group when stage_fn preserves shape)
        nxt: dict = {}
        if seal and sends:
            out_groups: dict = {}
            for s, mb, y in sends:
                out_groups.setdefault((tuple(y.shape), y.dtype),
                                      []).append((s, mb, y))
            for members in out_groups.values():
                cts, tags, meta = protect_many(
                    [_edge_key(s) for s, _, _ in members],
                    [step * M + mb for _, mb, _ in members],
                    torch.stack([y for _, _, y in members]))
                for i, (s, _, _) in enumerate(members):
                    nxt[s] = (cts[i], tags[i], meta, d.epoch)
        else:
            for s, _, y in sends:
                nxt[s] = y
        inflight = nxt
        # epoch flip between ticks: the hand-offs sealed above keep their
        # sealing epoch and drain under it next tick
        if d is not None and rekey_every_n and (t + 1) % rekey_every_n == 0:
            d.advance_epoch()
    return torch.stack(outs)
