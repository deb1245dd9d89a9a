"""Declarative pipeline specs: the paper's Listing 1, as TOML (or a dict).

Port of ``repro/dsl/spec.py``.  The paper declares a pipeline as named
stages with worker counts and an SGX placement constraint.  The same
shape here — 12 lines for the whole DelayedFlights job::

    mode = "enclave"
    [stage.sgx_mapper]
    op = "identity"
    workers = 2
    constraint = "sgx"
    [stage.sgx_filter]
    op = "delay_filter_u32"
    const = 15
    workers = 2
    constraint = "sgx"
    [stage.reducer]
    reduce = "carrier_delay_stats"

``load_spec`` parses this (file path, TOML text, or an already-parsed
dict) into the same :class:`repro_torch.dsl.builder.StreamBuilder` the
fluent API produces, so both forms compile through one validator/fusion path
and are bit-identical to each other.

Accepted keys — top level (or under ``[pipeline]``): ``mode``,
``rekey_every_n``, ``window_chunks``, ``seed``, ``name``.  Per stage
(``[stage.<name>]`` tables in file order, or a ``[[stage]]`` array with
explicit ``name`` keys): ``op``/``const`` (static registry operator),
``reduce`` (a registered reducer name), ``workers`` (alias ``count``,
the paper's key), and ``constraint`` — ``"sgx"`` or the paper's literal
``"type==sgx"`` mean enclave placement; anything else (or absent) means
unconstrained.

TOML is parsed by the standard library's ``tomllib`` (Python 3.11 and
later).  Malformed TOML raises :class:`SpecError` ("cannot parse ..."),
the documented contract (the reference lets ``tomllib``'s own error
out).
"""
from __future__ import annotations

import os
import tomllib
from typing import Any, Dict, List, Optional, Union

from repro_torch.dsl.builder import StreamBuilder, stream

# the paper writes `constraint:type==sgx`; accept the obvious spellings
_SGX_WORDS = ("sgx", "type==sgx", "type == sgx")

FILTER_OPS = ("delay_filter_u32", "threshold_mask")

# eager-validation contract: a typo'd key must fail the load, not run
# the pipeline with a silent default (`conts = 15` -> threshold 0)
_TOP_KEYS = ("mode", "rekey_every_n", "window_chunks", "seed", "name",
             "pipeline", "stage")
_STAGE_KEYS = ("name", "op", "const", "workers", "count", "constraint",
               "kind", "reduce")


class SpecError(ValueError):
    """A malformed spec document (parse- or shape-level)."""


# --------------------------------------------------------------- parsing


def parse_toml(text: str) -> Dict[str, Any]:
    """Parse TOML text; :class:`SpecError` if it is malformed."""
    try:
        return tomllib.loads(text)
    except tomllib.TOMLDecodeError as e:
        raise SpecError(f"cannot parse TOML: {e}") from None


# --------------------------------------------------------------- loading


def _stage_list(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    stages = doc.get("stage")
    if stages is None:
        raise SpecError("spec has no stages: add [stage.<name>] tables "
                        "or a [[stage]] array")
    if isinstance(stages, dict):                 # [stage.<name>] form
        out = []
        for name, body in stages.items():
            if not isinstance(body, dict):
                raise SpecError(f"[stage.{name}] must be a table")
            out.append({"name": name, **body})
        return out
    if isinstance(stages, list):                 # [[stage]] form
        for i, s in enumerate(stages):
            if "name" not in s:
                raise SpecError(f"[[stage]] #{i} is missing a name")
        return [dict(s) for s in stages]
    raise SpecError(f"unrecognized stage collection: {type(stages)}")


def _is_sgx(constraint: Any) -> bool:
    return isinstance(constraint, str) \
        and constraint.strip().lower() in _SGX_WORDS


def load_spec(spec: Union[str, "os.PathLike", Dict[str, Any]],
              source=None, *,
              reducers: Optional[Dict[str, Any]] = None) -> StreamBuilder:
    """Spec -> :class:`StreamBuilder` (same builder the fluent API uses).

    ``spec``: a dict, a path to a ``.toml`` file, or TOML text.
    ``source``: optional chunk iterable bound now (else pass it to
    ``.run``).  ``reducers``: extra ``{name: (fn, init)}`` pairs visible
    to this spec only, on top of the global registry.
    """
    if isinstance(spec, dict):
        doc = dict(spec)
    else:
        text = str(spec)
        if "\n" not in text and (os.path.exists(text)
                                 or text.endswith(".toml")):
            with open(text, "r") as f:
                text = f.read()
        doc = parse_toml(text)

    for k in doc:
        if k not in _TOP_KEYS:
            raise SpecError(f"unknown top-level key {k!r}; accepted: "
                            f"{sorted(_TOP_KEYS)}")
    pl = doc.get("pipeline", {})
    for k in pl:
        if k not in _TOP_KEYS or k in ("pipeline", "stage"):
            raise SpecError(f"unknown [pipeline] key {k!r}; accepted: "
                            f"{sorted(set(_TOP_KEYS) - {'pipeline', 'stage'})}")
    top = dict(pl)
    for k in ("mode", "rekey_every_n", "window_chunks", "seed", "name"):
        if k in doc and k not in top:
            top[k] = doc[k]

    sb = stream(source)
    if "mode" in top:
        sb = sb.secure(top["mode"])
    if "window_chunks" in top:
        sb = sb.window(int(top["window_chunks"]))
    if "seed" in top:
        sb = sb.seed(int(top["seed"]))
    if "rekey_every_n" in top:
        sb = sb._with_settings(rekey_every_n=int(top["rekey_every_n"]))

    for s in _stage_list(doc):
        name = s["name"]
        for k in s:
            if k not in _STAGE_KEYS:
                raise SpecError(
                    f"stage {name!r}: unknown key {k!r}; accepted: "
                    f"{sorted(_STAGE_KEYS)}")
        workers = int(s.get("workers", s.get("count", 1)))
        sgx = _is_sgx(s.get("constraint"))
        if "reduce" in s:
            rname = s["reduce"]
            if reducers and rname in reducers:
                fn, init = reducers[rname]
                sb = sb.reduce(fn, init, name=name)
            else:
                sb = sb.reduce(rname, name=name)   # global registry
            continue
        if "op" not in s:
            raise SpecError(f"stage {name!r} needs an 'op' (static "
                            f"operator) or a 'reduce' (named reducer)")
        op, const = s["op"], float(s.get("const", 0.0))
        if s.get("kind", "filter" if op in FILTER_OPS else "map") \
                == "filter":
            sb = sb.filter(op, const=const, name=name, workers=workers,
                           sgx=sgx)
        else:
            sb = sb.map(op, const=const, name=name, workers=workers,
                        sgx=sgx)
    return sb
