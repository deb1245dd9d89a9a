"""DSL compiler: validate eagerly, fuse where bit-exact, emit a Pipeline.

Port of ``repro/dsl/compile.py``.  The builder
(:mod:`repro_torch.dsl.builder`) and the spec loader
(:mod:`repro_torch.dsl.spec`) both land here.  Three jobs:

**Eager validation** — everything the engine would only discover
mid-stream is rejected at compile time, before any data is sealed:
unknown static operator names (with the registry listed), Python
closures placed ``sgx=True`` under ``mode="enclave"`` (the paper's
no-dynamic-linking rule — the engine raises this lazily per window; the
DSL raises it before the first chunk), duplicate stage names,
non-positive worker counts, unresolvable named reducers, and
``rekey_every_n`` cadences that even the per-chunk oracle engine could
not drain within the directory's ``epoch_history``.

**Fusion** — adjacent ``map``/``filter`` stages are merged into a single
stage when the op registry guarantees the composition is *bit-exact*:
identity absorption (``identity ∘ f == f`` to the bit, and the absorbed
stage's seal/open hop disappears).  Float compositions are deliberately
NOT fused — ``(x·a)·b != x·(a·b)`` under f32 rounding.  Every decision,
taken or declined, is recorded and surfaces in ``Pipeline.report()``.
Stages pinned by ``.scale()`` or carrying a worker pool (``workers >
1``) are never absorbed.

**Emission** — the output is a plain :class:`repro_torch.core.pipeline
.Pipeline` on the requested device (``"cuda"`` by default); the DSL
contributes nothing to the streaming hot path.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import SecureStreamConfig
from repro_torch.core.observable import Op
from repro_torch.core.pipeline import Pipeline, Stage, resolve_device
from repro_torch.dsl.reducers import reducer_factory, resolve_reducer_on
from repro_torch.kernels.enclave_map.enclave_map import OPS

MODES = ("plain", "encrypted", "enclave")


class DSLValidationError(ValueError):
    """A pipeline description rejected at compile time (build, not run)."""


# ------------------------------------------------------------------ validate


def _stage_dicts(ops: Sequence[Op]) -> List[dict]:
    """Normalize builder Ops into flat stage descriptors."""
    out = []
    for o in ops:
        d = dict(o.meta)
        d["kind"] = o.kind
        d["fn"] = o.fn
        d["init"] = o.init
        out.append(d)
    return out


def validate(ops: Sequence[Op], mode: str) -> List[dict]:
    """Eager structural validation; returns normalized stage dicts."""
    if mode not in MODES:
        raise DSLValidationError(
            f"unknown mode {mode!r}; expected one of {MODES}")
    stages = _stage_dicts(ops)
    if not stages:
        raise DSLValidationError("empty pipeline: add map/filter/reduce "
                                 "stages before build()/run()")
    reduces = [i for i, s in enumerate(stages) if s["kind"] == "reduce"]
    if len(reduces) > 1:
        raise DSLValidationError("at most one reduce stage (it is terminal)")
    if reduces and reduces[0] != len(stages) - 1:
        raise DSLValidationError(
            f"reduce must be the terminal stage, found it at position "
            f"{reduces[0]} of {len(stages)}")
    seen = set()
    for s in stages:
        name = s["name"]
        if name in seen:
            raise DSLValidationError(
                f"duplicate stage name {name!r} — stage names are worker-id "
                f"prefixes and must be unique")
        seen.add(name)
        if int(s["workers"]) < 1:
            raise DSLValidationError(
                f"stage {name!r}: workers must be >= 1, got {s['workers']}")
        if s["kind"] == "reduce":
            if s["fn"] is None:
                reducer_factory(s["reducer"])     # raises with known names
            continue
        if s["fn"] is None:
            if s["op"] not in OPS:
                raise DSLValidationError(
                    f"stage {name!r}: unknown static op {s['op']!r}; "
                    f"registered ops: {sorted(OPS)}")
        elif mode == "enclave" and s["sgx"]:
            raise DSLValidationError(
                f"stage {name!r}: a Python closure cannot run sgx=True "
                f"under mode='enclave' — only registered static operators "
                f"are attestable (the paper's no-dynamic-linking rule). "
                f"Use a registry op, or mark the stage sgx=False to run "
                f"it on the encrypted (non-enclave) path.")
    return stages


# ------------------------------------------------------------------- fusion


def _is_identity(s: dict) -> bool:
    return s["kind"] in ("map", "filter") and s["fn"] is None \
        and s["op"] == "identity"


def _absorbable(s: dict) -> bool:
    # an explicitly requested worker pool is part of the declared
    # topology — absorbing the stage would silently discard its fan-out
    return _is_identity(s) and not s.get("pinned") \
        and int(s["workers"]) == 1


_F32_OPS = ("scale_f32", "relu_f32", "square_f32", "threshold_mask")


def plan_fusion(stages: List[dict], enabled: bool
                ) -> Tuple[List[dict], Dict[str, List[str]], List[str]]:
    """-> (surviving stages, {survivor: [absorbed...]}, decision log).

    Only bit-exact merges are taken (identity absorption); everything
    considered is logged either way so ``report()`` shows the plan.
    """
    decisions: List[str] = []
    fused_from: Dict[str, List[str]] = {}
    prefix = [s for s in stages if s["kind"] != "reduce"]
    tail = [s for s in stages if s["kind"] == "reduce"]
    if not enabled:
        if len(prefix) > 1:
            decisions.append("fusion disabled (.fuse(False))")
        return stages, fused_from, decisions

    for s in prefix:
        if _is_identity(s) and s.get("pinned"):
            decisions.append(
                f"kept '{s['name']}': identity stage pinned by .scale()")
        elif _is_identity(s) and int(s["workers"]) > 1:
            decisions.append(
                f"kept '{s['name']}': identity stage has a worker pool "
                f"(workers={s['workers']}) — absorbing it would discard "
                f"the declared fan-out")

    survivors: List[dict] = []
    pending: List[str] = []
    for s in prefix:
        if _absorbable(s):
            pending.append(s["name"])
            continue
        if pending:
            fused_from.setdefault(s["name"], []).extend(pending)
            pending = []
        survivors.append(s)
    if pending:                       # trailing identities, or all-identity
        if survivors:
            fused_from.setdefault(survivors[-1]["name"], []).extend(pending)
        else:
            last = next(s for s in reversed(prefix)
                        if s["name"] == pending[-1])
            survivors.append(last)
            if pending[:-1]:
                fused_from[last["name"]] = pending[:-1]

    for host, absorbed in fused_from.items():
        decisions.append(
            f"fused {absorbed} into '{host}': identity is an exact u32 "
            f"passthrough (identity∘f == f bit-exact; "
            f"{len(absorbed)} seal/open hop(s) removed)")
    for a, b in zip(survivors, survivors[1:]):
        # identity survivors were already logged above with their real
        # keep-reason (pinned / worker pool)
        if a["fn"] is None and b["fn"] is None \
                and not _is_identity(a) and not _is_identity(b):
            why = "f32 composition reorders rounding" \
                if a["op"] in _F32_OPS and b["op"] in _F32_OPS \
                else "the composed semantics are not registered"
            decisions.append(
                f"kept '{a['name']}'|'{b['name']}' separate: no bit-exact "
                f"fused kernel for {a['op']}∘{b['op']} in the op registry "
                f"({why})")
    return survivors + tail, fused_from, decisions


# ----------------------------------------------------------------- emission


def _to_stage(s: dict, device) -> Stage:
    if s["kind"] == "reduce":
        if s["fn"] is not None:
            # deep-copy the caller's init per build: builders are shared
            # and reducers rebind acc keys in place, so a shared init
            # would make a second run start from the first run's totals
            fn, init = s["fn"], copy.deepcopy(s["init"])
        else:
            fn, init = resolve_reducer_on(s["reducer"], device)
        return Stage(s["name"], op="custom", reduce_fn=fn, reduce_init=init,
                     workers=int(s["workers"]), sgx=bool(s["sgx"]))
    if s["fn"] is not None:
        return Stage(s["name"], op="custom", fn=s["fn"],
                     workers=int(s["workers"]), sgx=bool(s["sgx"]))
    return Stage(s["name"], op=s["op"], const=float(s["const"]),
                 workers=int(s["workers"]), sgx=bool(s["sgx"]))


def compile_pipeline(ops: Sequence[Op], *, mode: str = "enclave",
                     seed: int = 0, directory=None, window_chunks: int = 8,
                     fuse: bool = True,
                     rekey_every_n: Optional[int] = None,
                     device=None, tracer=None, monitor=None,
                     retry=None, chaos=None) -> Pipeline:
    """Validate, fuse, and emit a :class:`Pipeline` on ``device`` (the
    card unless the caller names another) from a DSL op chain.

    ``rekey_every_n`` (when known at build time, e.g. from a spec file)
    triggers the eager cadence-vs-``epoch_history`` rejection the engine
    would otherwise raise at ``run()``.  ``tracer``/``monitor`` (from
    ``StreamBuilder.trace``/``.monitor``) and ``retry``/``chaos`` (from
    ``.retry``/``.chaos``) are attached to the emitted pipeline; None
    keeps each off."""
    stage_dicts = validate(ops, mode)
    fused, fused_from, decisions = plan_fusion(stage_dicts, fuse)
    dev = resolve_device(device)
    p = Pipeline([_to_stage(s, dev) for s in fused],
                 SecureStreamConfig(mode=mode),
                 seed=seed, directory=directory, window_chunks=window_chunks,
                 fusion={"fused_from": fused_from, "decisions": decisions},
                 device=dev, tracer=tracer, monitor=monitor, retry=retry,
                 chaos=chaos)
    if rekey_every_n and mode != "plain":
        # the same guard Pipeline.run applies — surfaced at build time
        p._clamp_window_for_rekey(p.window_chunks, int(rekey_every_n))
    return p
