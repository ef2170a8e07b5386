"""The port's graph IR, passes and planner against the JAX reference.

Every ``cnn_zoo`` model at its default (reduced) size is built by both
packages' builders; after ``fuse_cbr``, ``link_operators`` and
``dos_split`` both give the same node names, op types, edges, link groups
and ``SplitPlan`` s (under ``DeviceSpec.tms320c6678()``), and the same
PassReport node and edge deltas.  The analytic per-op counts agree
exactly, and with the cost-model constants set to the reference's TPU v5e
values (inside these tests only) the d-Xenos planner picks the same best
scheme.  None of this needs JAX to run: the reference's passes are pure
Python.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs import cnn_zoo as ref_zoo
from repro.core import costmodel as ref_cm
from repro.core import dos as ref_dos
from repro.core import linking as ref_linking
from repro.core import patterns as ref_patterns
from repro.core import pipeline as ref_pipeline
from repro.core import planner as ref_planner
from repro_torch.configs import cnn_zoo as port_zoo
from repro_torch.core import costmodel as port_cm
from repro_torch.core import dos as port_dos
from repro_torch.core import linking as port_linking
from repro_torch.core import patterns as port_patterns
from repro_torch.core import pipeline as port_pipeline
from repro_torch.core import planner as port_planner
from repro_torch.core.graph import Graph, OP_VOCABULARY
from repro_torch.launch import optimize_graph as port_launch

ZOO = sorted(ref_zoo.ZOO)
PASSES = ("fuse_cbr", "link_operators", "dos_split")


def _structure(g):
    """Everything a rewrite may change, as plain data."""
    nodes = [(n.name, n.op_type, tuple(n.inputs), tuple(n.outputs),
              tuple(n.params), repr(sorted(n.attrs.items())))
             for n in g.nodes]
    tensors = {t: (s.shape, s.dtype, s.layout, s.producer)
               for t, s in g.tensors.items()}
    return nodes, tensors, list(g.inputs), list(g.params), list(g.outputs)


def _groups(linking, g):
    return {gid: [n.name for n in members]
            for gid, members in linking.link_groups(g).items()}


def _plans(dos, g):
    return {name: dataclasses.asdict(p) for name, p in dos.plans(g).items()}


def _dataflow(g):
    return [(n.name, {k: v for k, v in n.dataflow.items()
                      if k != "split_plan"}) for n in g.nodes]


def test_zoo_and_vocabulary_match_the_reference():
    from repro.core.graph import OP_VOCABULARY as REF_VOCAB
    assert OP_VOCABULARY == REF_VOCAB
    assert sorted(port_zoo.ZOO) == ZOO


@pytest.mark.parametrize("name", ZOO)
def test_builders_name_every_tensor_like_the_reference(name):
    assert _structure(port_zoo.build(name)) == _structure(ref_zoo.build(name))


@pytest.mark.parametrize("name", ZOO)
def test_passes_rewrite_like_the_reference(name):
    """Same nodes, edges, link groups, split plans, dataflow metadata and
    PassReport deltas after fuse -> link -> DOS on the paper's device."""
    ref_g, port_g = ref_zoo.build(name), port_zoo.build(name)
    ref_out, ref_rep = ref_pipeline.optimize(
        ref_g, ref_dos.DeviceSpec.tms320c6678(), passes=PASSES)
    port_out, port_rep = port_pipeline.optimize(
        port_g, port_dos.DeviceSpec.tms320c6678(), passes=PASSES)
    assert _structure(port_out) == _structure(ref_out)
    assert _groups(port_linking, port_out) == _groups(ref_linking, ref_out)
    assert _plans(port_dos, port_out) == _plans(ref_dos, ref_out)
    assert _dataflow(port_out) == _dataflow(ref_out)
    deltas = lambda rep: [(p.name, p.nodes_before, p.nodes_after,
                           p.edges_before, p.edges_after, p.verified)
                          for p in rep.passes]
    assert deltas(port_rep) == deltas(ref_rep)
    summaries = lambda rep: [p.summary for p in rep.passes]
    assert summaries(port_rep) == summaries(ref_rep)
    assert port_pipeline.verify_graph(port_out) == []


@pytest.mark.parametrize("name", ZOO)
def test_patterns_and_mode_pipelines_match(name):
    ref_g, port_g = ref_zoo.build(name), port_zoo.build(name)
    as_lists = lambda found: {k: [(m.kind, m.nodes) for m in v]
                              for k, v in found.items()}
    assert as_lists(port_patterns.identify(port_g)) == \
        as_lists(ref_patterns.identify(ref_g))
    for mode in ("vanilla", "ho", "xenos"):
        r, _ = ref_pipeline.optimize_for_mode(ref_g, mode)
        p, _ = port_pipeline.optimize_for_mode(port_g, mode)
        assert _structure(p) == _structure(r), mode
    for level in sorted(ref_pipeline.LEVELS):
        r, _ = ref_pipeline.optimize(ref_g, level=level)
        p, _ = port_pipeline.optimize(port_g, level=level)
        assert _structure(p) == _structure(r), level


@pytest.mark.parametrize("name", ZOO)
def test_op_flops_and_bytes_agree_exactly(name):
    for stage in ((), PASSES):
        ref_g, _ = ref_pipeline.optimize(ref_zoo.build(name), passes=stage)
        port_g, _ = port_pipeline.optimize(port_zoo.build(name),
                                           passes=stage)
        for rn, pn in zip(ref_g.nodes, port_g.nodes):
            assert port_cm.op_flops(pn, port_g.tensors) == \
                ref_cm.op_flops(rn, ref_g.tensors)
            for linked in (False, True):
                assert port_cm.op_bytes(pn, port_g.tensors, linked) == \
                    ref_cm.op_bytes(rn, ref_g.tensors, linked)


@pytest.fixture
def v5e_constants(monkeypatch):
    """The reference's TPU v5e roofline constants, in the port's cost model
    for this test only."""
    monkeypatch.setattr(port_cm, "PEAK_FLOPS", ref_cm.PEAK_FLOPS)
    monkeypatch.setattr(port_cm, "HBM_BW", ref_cm.HBM_BW)
    monkeypatch.setattr(port_cm, "LINK_BW", ref_cm.ICI_BW)


@pytest.mark.parametrize("name", ZOO)
@pytest.mark.parametrize("sync", ["ring", "ps"])
def test_plan_distributed_picks_the_reference_scheme(name, sync,
                                                     v5e_constants):
    ref_g, port_g = ref_zoo.build(name), port_zoo.build(name)
    rb, rt, rall = ref_planner.plan_distributed(ref_g, 4, sync)
    pb, pt, pall = port_planner.plan_distributed(port_g, 4, sync)
    assert str(pb) == str(rb)
    assert pt == pytest.approx(rt, rel=1e-12)
    assert pall.keys() == rall.keys()
    for k in rall:
        assert pall[k] == pytest.approx(rall[k], rel=1e-12)
    assert {k: str(v) for k, v in
            port_planner.plan_mix(port_g, 4, sync).items()} == \
        {k: str(v) for k, v in ref_planner.plan_mix(ref_g, 4, sync).items()}


def test_dxenos_pass_summary_matches_reference(v5e_constants):
    ref_g, port_g = ref_zoo.build("resnet18"), port_zoo.build("resnet18")
    opts = {"n_devices": 4, "sync": "ring"}
    r, rrep = ref_pipeline.optimize(ref_g, passes=("dxenos_plan",),
                                    options=opts, cache=False)
    p, prep = port_pipeline.optimize(port_g, passes=("dxenos_plan",),
                                     options=opts, cache=False)
    assert prep.passes[0].summary["best_scheme"] == \
        rrep.passes[0].summary["best_scheme"]
    assert [n.dataflow.get("partition_scheme") for n in p.nodes] == \
        [n.dataflow.get("partition_scheme") for n in r.nodes]


def test_enumerated_schemes_match():
    for n in (1, 2, 4, 8, 12):
        assert [str(s) for s in port_planner.enumerate_schemes(n)] == \
            [str(s) for s in ref_planner.enumerate_schemes(n)]


def test_default_device_is_the_h100_and_the_dsp_spec_carries_over():
    d = port_dos.DeviceSpec()
    assert (d.n_units, d.l2_bytes, d.name) == (132, 227 * 1024, "h100_sxm")
    assert dataclasses.asdict(port_dos.DeviceSpec.tms320c6678()) == \
        dataclasses.asdict(ref_dos.DeviceSpec.tms320c6678())
    assert port_dos.FMAP_PRIORITY == ref_dos.FMAP_PRIORITY
    assert port_dos.PARAM_PRIORITY == ref_dos.PARAM_PRIORITY
    assert port_dos.COMPUTE_OPS == ref_dos.COMPUTE_OPS


@pytest.mark.parametrize("name", ["resnet18", "bert_s", "lstm"])
def test_split_plans_on_the_h100_spec_fit_shared_memory(name):
    """On the port's own default device every planned compute op spreads
    over the SMs and records whether its param chunk fits 227 KB."""
    g, _ = port_pipeline.optimize(port_zoo.build(name))
    plans = port_dos.plans(g)
    assert plans
    for p in plans.values():
        assert p.total_parts >= 1
        assert p.fits_l2 or p.notes


def test_levels_and_modes_match_reference():
    assert port_pipeline.LEVELS == ref_pipeline.LEVELS
    assert port_pipeline.DEFAULT_LEVEL == ref_pipeline.DEFAULT_LEVEL
    assert port_pipeline.MODE_PASSES == ref_pipeline.MODE_PASSES
    with pytest.raises(port_pipeline.PipelineError):
        port_pipeline.resolve_passes(level=99)
    with pytest.raises(port_pipeline.PipelineError):
        port_pipeline.optimize_for_mode(port_zoo.build("lstm"), "fast")


def test_verifier_flags_what_the_reference_flags():
    """A dangling edge and a detached link group, in both packages."""
    found = []
    for zoo, pipe in ((ref_zoo, ref_pipeline), (port_zoo, port_pipeline)):
        g = zoo.build("mobilenet")
        g.nodes[3].inputs[0] = "nowhere"
        g.nodes[0].dataflow["link_group"] = 7
        g.nodes[-1].dataflow["link_group"] = 7
        found.append(pipe.verify_graph(g))
    assert found[0] and found[1] == found[0]


def test_kernel_plan_routes_linked_matmul_to_cuda_on_the_card():
    plan, _ = port_pipeline.select_kernel_plan({"accelerator": "cuda"})
    assert plan.linked_matmul == "cuda"
    plan, _ = port_pipeline.select_kernel_plan({"accelerator": "cpu"})
    assert plan.linked_matmul == "torch"
    assert port_pipeline.KernelPlan().linked_matmul == "torch"
    with pytest.raises(port_pipeline.PipelineError):
        port_pipeline.KernelPlan(linked_matmul="pallas")


def test_launch_graphs_are_the_papers_chains():
    """The Figure-5 graph is the reference example's, and each CBRA graph
    links into exactly one ``cbra`` op."""
    from examples.optimize_graph import build_fig5_graph
    assert _structure(port_launch.fig5_graph()) == \
        _structure(build_fig5_graph())
    for shape, oc in (((1, 8, 8, 1024), 1024), ((1, 224, 224, 24), 224)):
        g, _ = port_pipeline.optimize(port_launch.cbra_graph("t4", shape, oc))
        assert [n.op_type for n in g.nodes] == ["cbra"]
        assert g.tensors[g.outputs[0]].shape == \
            (shape[0], shape[1] // 2, shape[2] // 2, oc)


def test_modeled_saving_credits_linking_like_the_reference():
    ref_g = ref_zoo.build("shufflenet")
    port_g = port_zoo.build("shufflenet")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_cm, "PEAK_FLOPS", ref_cm.PEAK_FLOPS)
        mp.setattr(port_cm, "HBM_BW", ref_cm.HBM_BW)
        _, r = ref_pipeline.optimize(ref_g, cache=False)
        _, p = port_pipeline.optimize(port_g, cache=False)
    assert p.modeled_before_s == pytest.approx(r.modeled_before_s, rel=1e-12)
    assert p.modeled_after_s == pytest.approx(r.modeled_after_s, rel=1e-12)
    assert np.isfinite(p.modeled_saving) and p.modeled_saving > 0
    assert "PassReport[shufflenet" in p.format()


def test_graph_clone_and_stats_match():
    ref_g, port_g = ref_zoo.build("squeezenet"), port_zoo.build("squeezenet")
    assert port_g.param_bytes() == ref_g.param_bytes()
    assert port_g.intermediate_bytes() == ref_g.intermediate_bytes()
    assert [n.name for n in port_g.toposorted()] == \
        [n.name for n in ref_g.toposorted()]
    c = port_g.clone()
    c.nodes[0].dataflow["x"] = 1
    assert "x" not in port_g.nodes[0].dataflow
    assert isinstance(c, Graph)
