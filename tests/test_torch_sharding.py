"""The d-Xenos sharding rules on the port against the reference's: the
parameter, cache and optimizer PartitionSpecs of every arch on the
production meshes and the debug mesh, the DOS fallback ladder, and the
pure functions on drawn shapes.  Pure functions: no process group."""
import dataclasses

import jax
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.base import INPUT_SHAPES as REF_SHAPES
from repro.configs.base import all_configs as ref_configs
from repro.distributed import sharding as RSH
from repro.distributed import state_sharding as RSS
from repro.launch import dryrun as ref_dryrun
from repro.launch.mesh import _split as ref_split
from repro.models.model import Model as RefModel
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.configs.base import INPUT_SHAPES, ModelConfig
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import state_sharding as SS
from repro_torch.launch import dryrun, mesh as mesh_lib
from repro_torch.models.layers import LOGICAL_AXES, ParamSpec
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, adamw_init


class FakeMesh:
    """``tests/test_sharding_rules.py``'s pattern: names and sizes only."""

    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2}}
ARCHS = sorted(ref_configs())


def _norm(tree):
    """Either package's spec tree as nested dicts / tuples, each spec a
    ("P", entries) pair, a QuantMoment of specs a ("Q", q, scale, shape)
    tuple."""
    if isinstance(tree, (JP, SH.PartitionSpec)):
        return ("P", tuple(tree))
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if type(tree).__name__ == "QuantMoment":
        return ("Q", _norm(tree.q), _norm(tree.scale), tuple(tree.shape))
    if isinstance(tree, tuple):
        return tuple(_norm(v) for v in tree)
    raise TypeError(type(tree))


def _port_cfg(ref_cfg):
    return ModelConfig(**dataclasses.asdict(ref_cfg))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh):
    ref_cfg = ref_configs()[arch]
    sizes = MESHES[mesh]
    ref = RefModel(ref_cfg, mesh=FakeMesh(sizes)).partition_specs()
    port = Model(_port_cfg(ref_cfg), mesh=SH.MeshShape(sizes),
                 device="cpu").partition_specs()
    assert _norm(port) == _norm(ref)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, shape, mesh):
    if (arch, shape) in dryrun.SKIPS:
        pytest.skip(dryrun.SKIPS[(arch, shape)])
    sizes = MESHES[mesh]
    ref_cfg = ref_dryrun.config_for(arch, shape)
    caches = RefModel(ref_cfg).input_specs(REF_SHAPES[shape])["caches"]
    B = REF_SHAPES[shape].global_batch
    port_caches = Model(_port_cfg(ref_cfg), device="cpu").input_specs(
        INPUT_SHAPES[shape])["caches"]
    for kw in ({}, {"seq_shard": True}, {"kv_axis": None}):
        port = SS.cache_partition_specs(port_caches, SH.MeshShape(sizes),
                                        global_batch=B, **kw)
        if type(caches) is tuple:
            # a layer pattern's per-layer caches have no layer axis: the
            # reference's specs assume one; the port's are each leaf's in
            # a one-layer stack, less the layer entry
            with pytest.raises(IndexError):
                RSS.cache_partition_specs(caches, FakeMesh(sizes),
                                          global_batch=B, **kw)
            one = [jax.tree.map(lambda x: jax.ShapeDtypeStruct(
                (1,) + x.shape, x.dtype), c) for c in caches]
            ref = tuple(jax.tree.map(
                lambda s: JP(*tuple(s)[1:]),
                RSS.cache_partition_specs(c, FakeMesh(sizes),
                                          global_batch=B, **kw),
                is_leaf=lambda x: isinstance(x, JP)) for c in one)
        else:
            ref = RSS.cache_partition_specs(caches, FakeMesh(sizes),
                                            global_batch=B, **kw)
        assert _norm(port) == _norm(ref), kw


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_specs_match_reference(arch, mesh):
    sizes = MESHES[mesh]
    ref_cfg = ref_configs()[arch]
    rm = RefModel(ref_cfg, mesh=FakeMesh(sizes))
    pm = Model(_port_cfg(ref_cfg), mesh=SH.MeshShape(sizes), device="cpu")
    for dt in ("float32", "bfloat16", "int8"):
        ref_abs = jax.eval_shape(
            lambda p: ref_adamw_init(p, RefAdamWConfig(moment_dtype=dt)),
            rm.abstract())
        ref = RSS.opt_partition_specs(ref_abs, rm.partition_specs(),
                                      FakeMesh(sizes))
        fm = FakeTensorMode()
        with fm:   # shapes only: the moments are never allocated
            port_abs = adamw_init(pm.abstract(fm),
                                  AdamWConfig(moment_dtype=dt))
        port = SS.opt_partition_specs(port_abs, pm.partition_specs(),
                                      SH.MeshShape(sizes))
        assert _norm(port.step) == _norm(ref.step)
        assert _norm(port.m) == _norm(ref.m), dt
        assert _norm(port.v) == _norm(ref.v), dt


# -- the reference's ladder cases (tests/test_sharding_rules.py) -------------

MESH = SH.MeshShape({"data": 16, "model": 16})


def _spec(shape, axes):
    rules = SH.rules_for(type("C", (), {"sharding_overrides": ()})(), MESH)
    return SH.spec_for_axes(axes, rules, shape, MESH)


def test_outc_first_even():
    assert _spec((4096, 64, 128), ("embed", "heads", None)) \
        == SH.P(None, "model", None)


def test_fallback_to_embed_when_heads_uneven():
    assert _spec((7168, 56, 128), ("embed", "heads", None)) \
        == SH.P("model", None, None)


def test_fallback_drops_when_nothing_divides():
    assert _spec((7, 5, 3), ("embed", "heads", None)) \
        == SH.P(None, None, None)


def test_batch_axes_for():
    m = SH.MeshShape({"pod": 2, "data": 16, "model": 16})
    assert SH.batch_axes_for(m, 256) == ("pod", "data")
    assert SH.batch_axes_for(m, 128) == ("pod", "data")
    assert SH.batch_axes_for(m, 16) == ("data",)
    assert SH.batch_axes_for(m, 1) == ()


def test_enforce_divisible_relocates():
    out = SS.enforce_divisible(SH.P(None, "data", None, "model", None),
                               (32, 128, 1024, 5, 64), MESH)
    assert out == SH.P(None, "data", None, None, "model")
    out2 = SS.enforce_divisible(SH.P(None, "data", None, "model", None),
                                (32, 128, 1024, 16, 64), MESH)
    assert out2 == SH.P(None, "data", None, "model", None)


# -- the pure functions on drawn inputs ----------------------------------------

SIZES = st.sampled_from([1, 2, 3, 4, 5, 8, 16])
meshes = st.one_of(
    st.tuples(SIZES, SIZES).map(lambda s: {"data": s[0], "model": s[1]}),
    st.tuples(SIZES, SIZES, SIZES).map(
        lambda s: {"pod": s[0], "data": s[1], "model": s[2]}))
DIMS = st.sampled_from([1, 2, 3, 5, 7, 8, 16, 24, 56, 64, 128, 256])
AXES = [a for a in LOGICAL_AXES]
overrides = st.dictionaries(
    st.sampled_from([a for a in AXES if a is not None]),
    st.sampled_from([None, "data", "model", "pod", ("pod", "data")]),
    max_size=3)


@settings(max_examples=200, deadline=None)
@given(sizes=meshes, data=st.data(), over=overrides)
def test_spec_for_axes_matches_reference(sizes, data, over):
    n = data.draw(st.integers(1, 4))
    axes = tuple(data.draw(st.sampled_from(AXES)) for _ in range(n))
    shape = tuple(data.draw(DIMS) for _ in range(n))
    cfg = type("C", (), {"sharding_overrides": tuple(over.items())})()
    ref = RSH.spec_for_axes(axes, RSH.rules_for(cfg, FakeMesh(sizes)),
                            shape, FakeMesh(sizes))
    ms = SH.MeshShape(sizes)
    port = SH.spec_for_axes(axes, SH.rules_for(cfg, ms), shape, ms)
    assert tuple(port) == tuple(ref)
    # without a shape: the rules alone
    assert tuple(SH.spec_for_axes(axes, SH.rules_for(cfg, ms))) \
        == tuple(RSH.spec_for_axes(axes, RSH.rules_for(cfg, FakeMesh(sizes))))


@settings(max_examples=200, deadline=None)
@given(sizes=meshes, data=st.data())
def test_enforce_divisible_matches_reference(sizes, data):
    n = data.draw(st.integers(1, 5))
    shape = tuple(data.draw(DIMS) for _ in range(n))
    names = list(sizes) + [("pod", "data")] if "pod" in sizes \
        else list(sizes)
    entries = [data.draw(st.sampled_from([None] + names)) for _ in range(n)]
    used, parts = set(), []
    for e in entries:   # a spec names each mesh axis once
        group = e if isinstance(e, tuple) else (e,)
        if e is None or used & set(group):
            parts.append(None)
        else:
            used |= set(group)
            parts.append(e)
    ref = RSS.enforce_divisible(JP(*parts), shape, FakeMesh(sizes))
    port = SS.enforce_divisible(SH.P(*parts), shape, SH.MeshShape(sizes))
    assert tuple(port) == tuple(ref)


@settings(max_examples=200, deadline=None)
@given(sizes=meshes, batch=st.integers(1, 1024))
def test_batch_axes_for_matches_reference(sizes, batch):
    assert SH.batch_axes_for(SH.MeshShape(sizes), batch) \
        == RSH.batch_axes_for(FakeMesh(sizes), batch)
    for nd in (1, 2, 3):
        for last in (None, "model"):
            baxes = SH.batch_axes_for(SH.MeshShape(sizes), batch)
            assert tuple(SH.activation_spec(baxes, nd, last)) \
                == tuple(RSH.activation_spec(baxes, nd, last))


def test_param_partition_specs_of_logical_axes():
    """A leaf given as logical axes alone takes the rules' spec."""
    rules = SH.rules_for(None, MESH)
    tree = {"a": ("embed", "heads", None),
            "b": ParamSpec((7, 32), ("vocab", "embed"))}
    out = SH.param_partition_specs(tree, rules, MESH)
    # vocab 7 does not take the 16-way model axis: the ladder moves it
    assert out == {"a": SH.P(None, "model", None), "b": SH.P(None, "model")}
    assert tuple(RSH.spec_for_axes(("embed", "heads", None),
                                   RSH.rules_for(None, FakeMesh(MESH.shape)))) \
        == tuple(out["a"])


def test_sharding_rules_divisibility():
    """Every arch gives even shards on the debug mesh's axes (data 4,
    model 2), as the reference's structural check does."""
    mesh = mesh_lib.make_debug_mesh(8)
    assert mesh.shape == {"data": 4, "model": 2}
    for name, cfg in sorted(ref_configs().items()):
        m = Model(_port_cfg(cfg), mesh=mesh, device="cpu")
        specs = _flat(m.partition_specs())
        shapes = _flat(m.param_specs())
        assert len(specs) == len(shapes)
        for spec, ps in zip(specs, shapes):
            for dim, entry in enumerate(spec):
                if entry is None:
                    continue
                names = entry if isinstance(entry, tuple) else (entry,)
                n = 1
                for nm in names:
                    n *= mesh.shape[nm]
                assert ps.shape[dim] % n == 0, (name, ps.shape, spec)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


def test_meshes_match_reference():
    """The production and debug meshes: the reference's names and sizes."""
    assert mesh_lib.make_production_mesh().shape == {"data": 16, "model": 16}
    assert mesh_lib.make_production_mesh(multi_pod=True).shape \
        == {"pod": 2, "data": 16, "model": 16}
    for n in (1, 2, 6, 8, 12, 256):
        assert tuple(mesh_lib.make_debug_mesh(n).shape.values()) \
            == ref_split(n)
    assert mesh_lib.make_debug_mesh(8, multi_pod=True).shape \
        == {"pod": 2, "data": 2, "model": 2}
    with pytest.raises(ValueError):
        mesh_lib.make_debug_mesh(7, multi_pod=True)
