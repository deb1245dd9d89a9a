"""The torch port's DSL (fluent builder, TOML spec, compiler) against the
JAX reference's on the CPU: the same DelayedFlights job gives the same
bits in every mode, under rekey + revocation, from the example spec
file; the fusion decisions, ``describe()`` and the validation errors
(type and message) are the reference's.  Port builders run with
``.device("cpu")``; the default is the card."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attest.directory import KeyDirectory as JKeyDirectory
from repro.dsl import load_spec as j_load_spec
from repro.dsl import stream as j_stream
from repro.dsl.spec import _parse_mini_toml as j_parse_mini_toml
from repro_torch.attest.directory import KeyDirectory
from repro_torch.configs.base import SecureStreamConfig
from repro_torch.core.pipeline import Pipeline, Stage
from repro_torch.data.synthetic import flight_chunks, flight_records
from repro_torch.dsl import (REDUCERS, SpecError, load_spec,
                             register_reducer, stream)
from repro_torch.dsl.reducers import resolve_reducer
from repro_torch.dsl.spec import parse_toml
from _torch_threads import one_torch_thread  # noqa: F401

N_RECORDS, CHUNK = 512, 64           # 8 chunks of 64 records
SPEC_PATH = os.path.join(os.path.dirname(__file__), "..", "examples",
                         "flight_delay.toml")
MODES = ("plain", "encrypted", "enclave")

TOML_FORM = """\
mode = "MODE"
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
"""


def _src():
    return flight_chunks(N_RECORDS, CHUNK, seed=1)


def _jsrc():
    return (jnp.asarray(c) for c in _src())


def _fluent(s, workers=2):
    return (s()
            .map("identity", name="sgx_mapper", workers=workers, sgx=True)
            .filter("delay_filter_u32", const=15, name="sgx_filter",
                    workers=workers, sgx=True)
            .reduce("carrier_delay_stats", name="reducer"))


def _np(out):
    return tuple(np.asarray(out[k]) for k in ("count", "sum"))


def _same(*outs):
    first = _np(outs[0])
    for o in outs[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(first, _np(o)))


def _numpy():
    recs = flight_records(N_RECORDS, seed=1)
    keep = recs[:, 1] > 15
    return {"count": np.bincount(recs[keep, 0], minlength=20).astype(
                np.float64),
            "sum": np.bincount(recs[keep, 0], weights=recs[keep, 1]
                               .astype(np.float64), minlength=20)}


def _hand_built(mode):
    fn, init = resolve_reducer("carrier_delay_stats", device="cpu")
    return Pipeline([Stage("sgx_mapper", op="identity", workers=2),
                     Stage("sgx_filter", op="delay_filter_u32", const=15,
                           workers=2),
                     Stage("reducer", op="custom", reduce_fn=fn,
                           reduce_init=init)],
                    SecureStreamConfig(mode=mode), device="cpu")


def _fusion_view(rep):
    return {k: v for k, v in rep.items()
            if k == "fusion" or isinstance(v, dict) and "fused_from" in v}


# ------------------------------------------------------- the job, 3 modes


@pytest.mark.parametrize("mode", MODES)
def test_fluent_and_toml_equal_reference_hand_built_and_numpy(mode):
    fluent = _fluent(stream).device("cpu")
    toml = load_spec(TOML_FORM.replace("MODE", mode)).device("cpu")
    j_fluent = _fluent(j_stream)
    got = fluent.run(_src(), mode=mode)
    want = j_fluent.run(_jsrc(), mode=mode)
    _same(got, want, toml.run(_src()), _hand_built(mode).run(_src()),
          _numpy())
    assert _fusion_view(fluent.report()) == _fusion_view(j_fluent.report())
    assert toml.describe() == j_load_spec(
        TOML_FORM.replace("MODE", mode)).describe() == fluent.describe()
    # the compiled stage list is the hand-built one (workers=2 keeps the
    # identity stage: its declared fan-out is not absorbed)
    sig = [(s.name, s.op, s.const, s.workers, s.sgx)
           for s in fluent.pipeline.stages]
    assert sig == [(s.name, s.op, s.const, s.workers, s.sgx)
                   for s in _hand_built(mode).stages]


def test_dsl_rekey_and_revocation_equal_reference():
    outs = []
    for s, src, kd in ((stream, _src, KeyDirectory),
                       (j_stream, _jsrc, JKeyDirectory)):
        sb = _fluent(s).directory(kd(seed=0, epoch_history=64))
        if s is stream:
            sb = sb.device("cpu")

        def revoking(sb=sb, src=src):
            for i, c in enumerate(src()):
                if i == 3:
                    sb.pipeline.directory.revoke("sgx_mapper/w1")
                yield c
        outs.append((sb.run(revoking(), mode="enclave", rekey_every_n=3),
                     sb.report()))
    (got, rep), (want, j_rep) = outs
    _same(got, want, _numpy())
    assert rep["audit"] == j_rep["audit"]
    assert rep["audit"]["rekey"] >= 2 and rep["audit"]["revocation"] == 1
    for k in ("sgx_mapper", "sgx_filter"):
        assert rep[k]["per_worker"] == j_rep[k]["per_worker"]


def test_example_spec_file_and_the_oracle_engine_equal_reference():
    """examples/flight_delay.toml loads in both packages and agrees; the
    same spec on the per-chunk oracle engine (``.window(1)``) too."""
    sb = load_spec(SPEC_PATH).device("cpu")
    j_sb = j_load_spec(SPEC_PATH)
    got = sb.run(_src(), mode="encrypted")
    _same(got, j_sb.run(_jsrc(), mode="encrypted"), _numpy())
    assert sb.report()["fusion"] == j_sb.report()["fusion"]
    oracle = load_spec(SPEC_PATH).device("cpu").window(1)
    _same(oracle.run(_src(), mode="enclave"), got)
    assert oracle.pipeline.window_chunks == 1
    assert oracle.report()["sgx_filter"]["windows"] == N_RECORDS // CHUNK


# ------------------------------------------------------------------ fusion


CHAINS = {
    "identity_absorbed": lambda s: (
        s().map("identity", name="m")
        .filter("delay_filter_u32", const=15, name="f")
        .reduce("carrier_delay_stats", name="r")),
    "f32_declined": lambda s: (
        s().map("scale_f32", const=2.0, name="a")
        .map("scale_f32", const=3.0, name="b")),
    "unregistered_declined": lambda s: (
        s().map("relu_f32", name="a")
        .filter("delay_filter_u32", const=15, name="b")),
    "trailing_identity": lambda s: (
        s().map("scale_f32", const=2.0, name="a")
        .map("identity", name="tail")),
    "all_identity": lambda s: (
        s().map("identity", name="i0").map("identity", name="i1")
        .map("identity", name="i2")),
    "pinned": lambda s: (
        s().map("identity", name="m")
        .filter("delay_filter_u32", const=15, name="f").scale("m", 4)),
    "worker_pool": lambda s: (
        s().map("identity", name="m", workers=2)
        .filter("delay_filter_u32", const=15, name="f")),
    "disabled": lambda s: (
        s().map("identity", name="m").map("relu_f32", name="r")
        .fuse(False)),
}


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_fusion_decisions_and_describe_equal_reference(chain):
    sb = CHAINS[chain](stream).device("cpu")
    j_sb = CHAINS[chain](j_stream)
    p, jp = sb.build("encrypted"), j_sb.build("encrypted")
    assert p.fusion == jp.fusion
    assert [(s.name, s.op, s.const, s.workers, s.sgx) for s in p.stages] \
        == [(s.name, s.op, s.const, s.workers, s.sgx) for s in jp.stages]
    assert _fusion_view(p.report()) == _fusion_view(jp.report())
    assert sb.describe() == j_sb.describe()
    # fusion provenance survives a live rescale
    p2 = p.scale_stage(p.stages[-1].name, 3)
    assert p2.fusion == p.fusion


def test_fused_run_equals_unfused_and_the_observable_oracle():
    base = CHAINS["identity_absorbed"](stream).device("cpu")
    fused = base.run(_src(), mode="enclave")
    _same(fused, base.fuse(False).run(_src(), mode="enclave"),
          base.as_observable(_src()).subscribe(), _numpy())
    j_obs = CHAINS["identity_absorbed"](j_stream).as_observable(_jsrc())
    _same(fused, j_obs.subscribe())
    assert base.as_observable(_src()).describe() == j_obs.describe()


def test_shared_builder_reruns_do_not_accumulate_reduce_state():
    init = {"count": torch.zeros(20, dtype=torch.float64),
            "sum": torch.zeros(20, dtype=torch.float64)}
    fn, _ = resolve_reducer("carrier_delay_stats", device="cpu")
    sb = (stream().filter("delay_filter_u32", const=15, name="f")
          .reduce(fn, init, name="r").device("cpu"))
    first = sb.run(_src(), mode="plain")
    _same(first, sb.run(_src(), mode="plain"), _numpy())
    assert float(init["count"].sum()) == 0.0


def test_count_and_registered_reducers_equal_reference():
    assert stream().reduce("count").device("cpu").run(
        _src(), mode="encrypted") == j_stream().reduce("count").run(
        _jsrc(), mode="encrypted") == N_RECORDS // CHUNK

    @register_reducer("test_torch_dsl_total_delay")
    def _total(**kw):
        def fn(acc, chunk):
            return acc + int(chunk[:, 1].to(torch.int64).sum())
        return fn, 0
    try:
        out = stream(_src()).reduce("test_torch_dsl_total_delay").device(
            "cpu").run(mode="plain")
    finally:                  # the registry is process-wide
        REDUCERS.pop("test_torch_dsl_total_delay")
    assert out == int(flight_records(N_RECORDS, seed=1)[:, 1]
                      .astype(np.int64).sum())
    assert load_spec({"mode": "plain",
                      "stage": [{"name": "r", "reduce": "n"}]},
                     reducers={"n": ((lambda acc, c: acc + 1), 0)}) \
        .device("cpu").run(_src()) == N_RECORDS // CHUNK


# -------------------------------------------------------- eager validation


def _key_dir(s):
    return KeyDirectory if s is stream else JKeyDirectory


INVALID = {
    "unknown_op": lambda s: s().map("not_an_op").build("encrypted"),
    "closure_enclave": lambda s: s().map(lambda x: x * 2, name="c")
    .build("enclave"),
    "empty": lambda s: s().build("plain"),
    "terminal": lambda s: s().reduce("sum", name="r")
    .map("identity", name="m").build("plain"),
    "two_reduces": lambda s: s().reduce("sum", name="r")
    .reduce("count", name="q").build("plain"),
    "duplicate": lambda s: s().map("identity", name="x")
    .map("identity", name="x").build("plain"),
    "workers": lambda s: s().map("identity", workers=0).build("plain"),
    "unknown_reducer": lambda s: s().map("identity").reduce("nope")
    .build("plain"),
    "unknown_mode": lambda s: s().map("identity").build("tls"),
    "rekey_cadence": lambda s: s().map("scale_f32", const=2.0, name="s")
    .directory(_key_dir(s)(epoch_history=1))
    .build("encrypted", rekey_every_n=1),
    "scale_unknown": lambda s: s().map("identity", name="m")
    .scale("nope", 2),
}


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize("case", sorted(INVALID))
def test_validation_errors_equal_reference(case):
    got = _raised(lambda: INVALID[case](lambda: stream().device("cpu")))
    assert got == _raised(lambda: INVALID[case](j_stream))
    assert got[0] in ("DSLValidationError", "KeyError", "ValueError")


def test_closure_off_the_enclave_runs_on_the_encrypted_path():
    out = (stream().map(lambda x: x * 2.0, name="c", sgx=False)
           .device("cpu").build("enclave")
           .run(iter([np.ones(64, np.float32)])))
    assert torch.equal(out, torch.full((64,), 2.0))


SPECS = {
    "no_stages": {"mode": "plain"},
    "no_op": {"stage": [{"name": "x"}]},
    "no_name": {"stage": [{"op": "identity"}]},
    "stage_key": {"stage": [{"name": "f", "op": "delay_filter_u32",
                             "conts": 15}]},
    "top_key": {"mod": "plain", "stage": [{"name": "f", "op": "identity"}]},
    "pipeline_key": {"pipeline": {"mode": "plain", "rekey": 3},
                     "stage": [{"name": "f", "op": "identity"}]},
    "not_a_table": {"stage": {"f": 3}},
    "mini_parse": "[stage.f]\nop = ???\n",
}


@pytest.mark.parametrize("case", sorted(SPECS))
def test_spec_errors_equal_reference(case):
    doc = SPECS[case]
    if isinstance(doc, str):
        # malformed TOML: the port's parser and the reference's subset
        # parser both raise SpecError (the reference's tomllib path does
        # not: ROADMAP Queue 3)
        got = _raised(lambda: load_spec(doc))
        assert got[1].startswith("cannot parse TOML")
        assert _raised(lambda: j_parse_mini_toml(doc))[0] == "SpecError"
    else:
        got = _raised(lambda: load_spec(doc))
        assert got == _raised(lambda: j_load_spec(doc))
    assert got[0] == "SpecError"


def test_malformed_toml_raises_spec_error():
    """The documented contract: on Python 3.12 ``tomllib`` parses, and a
    malformed document is a SpecError, as the subset parser's is."""
    with pytest.raises(SpecError, match="cannot parse"):
        load_spec("stage = ???\n")
    with pytest.raises(SpecError, match="cannot parse"):
        parse_toml("[stage.f\nop = 1\n")


def test_spec_forms_and_mini_parser_equal_reference():
    doc = {"mode": "plain",
           "stage": [{"name": "f", "op": "delay_filter_u32", "const": 15,
                      "count": 2, "constraint": "type==sgx"},
                     {"name": "r", "reduce": "carrier_delay_stats"}]}
    p, jp = load_spec(doc).device("cpu").build(), j_load_spec(doc).build()
    assert [(s.name, s.workers, s.sgx) for s in p.stages] == \
        [(s.name, s.workers, s.sgx) for s in jp.stages]
    text = ("# comment\nname = \"x\"  # trailing\nn = 3\nf = 1.5\n"
            "flag = true\n[a.b]\nk = 'single'\n[[arr]]\nv = 1\n[[arr]]\n"
            "v = 2\n")
    assert parse_toml(text) == j_parse_mini_toml(text)


# ------------------------------------------------------ unported and device


@pytest.mark.parametrize("verb,item", [("trace", "item 11"),
                                       ("monitor", "item 11"),
                                       ("retry", "item 12"),
                                       ("chaos", "item 12")])
def test_unported_verbs_name_their_roadmap_item(verb, item):
    """The four verbs of ROADMAP Queue 1 items 1 and 2 (numbered 11 and
    12 when they were unported) are ported: each attaches its object to
    the builder, which hands it to the compiled pipeline."""
    from repro_torch.ft import ChaosPlan, RetryPolicy
    from repro_torch.obs import PipelineMonitor, Tracer
    obj = {"trace": Tracer, "monitor": PipelineMonitor,
           "retry": RetryPolicy, "chaos": ChaosPlan}[verb]()
    prop = {"trace": "tracer", "monitor": "health_monitor",
            "retry": "retry_policy", "chaos": "chaos_plan"}[verb]
    sb = stream().map("identity")
    assert getattr(sb, prop) is None
    sb2 = getattr(sb, verb)(obj)
    assert getattr(sb2, prop) is obj and getattr(sb, prop) is None
    p = sb2.device("cpu").build("encrypted")
    attr = {"trace": "tracer", "monitor": "monitor", "retry": "retry",
            "chaos": "chaos"}[verb]
    assert getattr(p, attr) is obj


def test_builds_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stream().map("identity").build("plain")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_spec(SPEC_PATH).build()
