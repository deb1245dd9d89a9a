"""repro_torch.dsl — the fluent pipeline DSL + declarative spec loader.

Port of ``repro/dsl``: :func:`stream` (fluent Listing-2 style) and
:func:`load_spec` (declarative Listing-1 style, TOML or dict), both
compiling through :mod:`repro_torch.dsl.compile` to the port's
:class:`repro_torch.core.pipeline.Pipeline` on the card (``.device(...)``
names another device), with nothing added to the streaming hot path.
"""
from repro_torch.dsl.builder import StreamBuilder, stream  # noqa: F401
from repro_torch.dsl.compile import (DSLValidationError,  # noqa: F401
                                     compile_pipeline)
from repro_torch.dsl.reducers import (REDUCERS,  # noqa: F401
                                      register_reducer, resolve_reducer)
from repro_torch.dsl.spec import SpecError, load_spec, parse_toml  # noqa
