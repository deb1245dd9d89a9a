"""The port's configs (``repro_torch/configs``) against the reference's:
the registry (``ARCH_IDS``, ``all_cells``, ``cell_supported``), each of
the ten ``ModelConfig``s and optimizer configs field for field, their
``reduce_for_smoke`` forms, and each parameter template's shapes and
dtypes and its counts (``param_count``, ``active_param_count``), without
allocating a parameter.
"""
import dataclasses

import jax
import pytest

import repro.configs as j_configs
from repro.models import api as j_api
from repro.models import layers as j_layers
from repro_torch import configs
from repro_torch.models import api
from repro_torch.models.layers import ParamSpec
from _torch_threads import one_torch_thread  # noqa: F401


def _asdict(cfg):
    return dataclasses.asdict(cfg)


def test_registry_equals_reference():
    assert configs.ARCH_IDS == j_configs.ARCH_IDS
    assert configs.all_cells() == j_configs.all_cells()
    assert len(configs.all_cells()) == 40
    for arch, shape in configs.all_cells():
        assert configs.cell_supported(arch, shape) == \
            j_configs.cell_supported(arch, shape), (arch, shape)
    assert [a for a in configs.ARCH_IDS
            if configs.get_model_config(a).sub_quadratic] == \
        ["xlstm-125m", "zamba2-1.2b"]


@pytest.mark.parametrize("arch", j_configs.ARCH_IDS)
def test_model_config_equals_reference_field_for_field(arch):
    cfg, jcfg = configs.get_model_config(arch), \
        j_configs.get_model_config(arch)
    assert _asdict(cfg) == _asdict(jcfg)
    assert _asdict(configs.reduce_for_smoke(cfg)) == \
        _asdict(j_configs.reduce_for_smoke(jcfg))
    opt, jopt = configs.get_optimizer_config(arch), \
        j_configs.get_optimizer_config(arch)
    jo = _asdict(jopt)
    for f in dataclasses.fields(opt):          # zero_sharding not ported
        assert getattr(opt, f.name) == jo[f.name], f.name


def _template_shapes(template, leaf, path=""):
    if leaf(template):
        return {path: (tuple(template.shape), str(template.dtype))}
    out = {}
    for k in template:
        out.update(_template_shapes(template[k], leaf, f"{path}/{k}"))
    return out


@pytest.mark.parametrize("arch", j_configs.ARCH_IDS)
def test_param_template_and_counts_equal_reference(arch):
    cfg, jcfg = configs.get_model_config(arch), \
        j_configs.get_model_config(arch)
    got = _template_shapes(api.param_template(cfg),
                           lambda t: isinstance(t, ParamSpec))
    want = _template_shapes(j_api.param_template(jcfg), j_layers.is_spec)
    assert got == want
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    if arch == "moonshot-v1-16b-a3b":
        assert round(cfg.param_count() / 1e6) == 28_058
    if arch == "kimi-k2-1t-a32b":
        assert round(cfg.param_count() / 1e6) == 1_041_167
    if cfg.family == "hybrid":
        assert [g[1] for g in api._hybrid_groups(cfg)] == \
            [6, 6, 6, 6, 6, 6, 2]
        assert api.num_shared_attn(cfg) == j_api.num_shared_attn(jcfg) == 6


@pytest.mark.parametrize("arch", j_configs.ARCH_IDS)
def test_cache_template_equals_reference(arch):
    cfg = configs.reduce_for_smoke(configs.get_model_config(arch))
    jcfg = j_configs.reduce_for_smoke(j_configs.get_model_config(arch))
    got = _template_shapes(api.cache_template(cfg, 2, 40),
                           lambda t: isinstance(t, ParamSpec))
    want = _template_shapes(j_api.cache_template(jcfg, 2, 40),
                            j_layers.is_spec)
    assert got == want
    assert jax.tree.structure(j_api.abstract_cache(jcfg, 2, 40)) is not None


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_param_draw_in_slabs(monkeypatch, dtype):
    """``ParamSpec.initialize`` draws a leaf of at most ``SLAB_ELEMENTS``
    values in one f32 draw, cast (as before slabs); a larger leaf in slabs
    along its first axis: the same shape and type, the same scale, and no
    slab a repeat of another."""
    import math

    import torch

    from repro_torch.models import layers
    spec = ParamSpec((6, 16, 32), ("layers", None, None), dtype=dtype)
    whole = torch.randn(spec.shape, generator=torch.Generator().manual_seed(3))
    whole = whole.mul_(1 / math.sqrt(16)).to(spec.torch_dtype)
    assert torch.equal(spec.initialize(torch.Generator().manual_seed(3),
                                       "cpu"), whole)
    monkeypatch.setattr(layers, "SLAB_ELEMENTS", 2 * 16 * 32 + 5)
    got = spec.initialize(torch.Generator().manual_seed(3), "cpu")
    assert got.shape == spec.shape and got.dtype == spec.torch_dtype
    assert torch.equal(got[:2], whole[:2])
    slabs = got.float().reshape(3, -1)
    assert all(not torch.equal(slabs[i], slabs[j])
               for i in range(3) for j in range(i))
    assert abs(float(got.float().std()) * math.sqrt(16) - 1) < 0.1
