"""The port's pass-registry API against the reference's
(``repro.core.pipeline``): ``graph_pass`` / ``unregister_pass``, a
corrupting pass or a false invariant raising at that pass, and
``verify=False`` on ``optimize`` / ``optimize_for_mode`` letting such a
pass through, with ``verify`` part of the optimize cache's key.  The
cases mirror ``tests/test_pipeline.py``'s registration and verification
tests, run on both packages where the reference's behaviour is the one
held.  Then ``launch/quickstart.py`` on the host, its printed op counts
against the reference's ``examples/quickstart.py``'s for the same graph.
"""
import contextlib
import importlib.util
import io
import re
from pathlib import Path

import pytest

from repro.configs import cnn_zoo as ref_zoo
from repro.core import graph as ref_G
from repro.core import pipeline as ref_pipeline
from repro.core.graph import Graph as RefGraph
from repro_torch.configs import cnn_zoo as port_zoo
from repro_torch.core import graph as port_G
from repro_torch.core import pipeline as port_pipeline
from repro_torch.core.graph import Graph as PortGraph
from repro_torch.launch import quickstart

ROOT = Path(__file__).resolve().parents[1]

PACKAGES = {
    "reference": (ref_pipeline, ref_zoo, RefGraph, ref_G),
    "port": (port_pipeline, port_zoo, PortGraph, port_G),
}


def _tiny_graph(Graph, G):
    g = Graph("tiny")
    x = g.add_input("x", (1, 8, 8, 4))
    y = G.conv2d(g, x, 8, 3)
    y = G.bn(g, y)
    y = G.relu(g, y)
    y = G.pool(g, y, "avg", 2)
    g.mark_output(y)
    return g


def _corrupt(g, ctx):
    out = g.clone()
    out.nodes.pop(0)       # drop the conv but keep its output tensor around
    return out


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_graph_pass_registration_roundtrip(pkg):
    pipeline, zoo, _, _ = PACKAGES[pkg]

    @pipeline.graph_pass("tmp_noop", "test-only no-op pass")
    def _noop(g, ctx):
        return g.clone()

    try:
        assert pipeline.REGISTRY["tmp_noop"].fn is _noop
        _, report = pipeline.optimize(zoo.build("mobilenet"),
                                      passes=("tmp_noop",))
        assert report.passes[0].name == "tmp_noop"
        assert report.passes[0].node_delta == 0
        with pytest.raises(pipeline.PipelineError):
            pipeline.register_pass(pipeline.REGISTRY["tmp_noop"])
    finally:
        pipeline.unregister_pass("tmp_noop")
    assert "tmp_noop" not in pipeline.REGISTRY
    pipeline.unregister_pass("tmp_noop")          # absent: a no-op


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_graph_pass_declares_invariants_and_summary(pkg):
    """The decorator's keywords reach the registered ``Pass``: a false
    invariant raises at that pass; the summary lands in the report."""
    pipeline, _, Graph, G = PACKAGES[pkg]

    @pipeline.graph_pass("tmp_lying", "claims an impossible invariant",
                         invariants=(("never_true", lambda g: False),),
                         summarize=lambda a, b: {"seen": b.num_ops()})
    def _lying(g, ctx):
        return g.clone()

    try:
        with pytest.raises(pipeline.PassVerificationError) as ei:
            pipeline.optimize(_tiny_graph(Graph, G), passes=("tmp_lying",),
                              cache=False)
        assert ei.value.pass_name == "tmp_lying"
        assert any("never_true" in p for p in ei.value.problems)
        _, report = pipeline.optimize(_tiny_graph(Graph, G),
                                      passes=("tmp_lying",), verify=False,
                                      cache=False)
        assert report.passes[0].summary == {"seen": 4}
        assert report.passes[0].verified is False
    finally:
        pipeline.unregister_pass("tmp_lying")


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_verify_false_lets_a_corrupting_pass_through(pkg):
    """``verify=True`` raises at the corrupting pass; ``verify=False``
    returns its graph unchecked.  The two are cached apart: a checked
    call after an unchecked one still raises."""
    pipeline, _, Graph, G = PACKAGES[pkg]
    pipeline.register_pass(pipeline.Pass(
        "tmp_corrupt", _corrupt, "test-only corrupted rewrite"))
    try:
        g = _tiny_graph(Graph, G)
        with pytest.raises(pipeline.PassVerificationError) as ei:
            pipeline.optimize(g, passes=("tmp_corrupt",))
        assert ei.value.pass_name == "tmp_corrupt" and ei.value.problems
        out, report = pipeline.optimize(g, passes=("tmp_corrupt",),
                                        verify=False)
        assert out.num_ops() == g.num_ops() - 1
        assert pipeline.verify_graph(out)            # corrupt, unchecked
        assert [r.verified for r in report.passes] == [False]
        _, again = pipeline.optimize(g, passes=("tmp_corrupt",),
                                     verify=False)
        assert again.cache_hit
        with pytest.raises(pipeline.PassVerificationError):
            pipeline.optimize(g, passes=("tmp_corrupt",))
        # a corrupt input is refused only when verifying
        with pytest.raises(pipeline.PassVerificationError) as ei:
            pipeline.optimize(out, passes=(), cache=False)
        assert ei.value.pass_name == "<input>"
        pipeline.optimize(out, passes=(), verify=False, cache=False)
    finally:
        pipeline.unregister_pass("tmp_corrupt")


def test_verify_is_part_of_the_cache_key():
    """The port's key is the reference's: (fingerprint, pass identities,
    options, device, verify)."""
    g = port_zoo.build("mobilenet")
    plist = port_pipeline.resolve_passes(level=3)
    dev = port_pipeline.DeviceSpec()
    on = port_pipeline._cache_key(g, plist, {}, dev, True)
    off = port_pipeline._cache_key(g, plist, {}, dev, False)
    assert on != off and on[:-1] == off[:-1] and (on[-1], off[-1]) == (
        True, False)
    rg = ref_zoo.build("mobilenet")
    ref = ref_pipeline._cache_key(rg, ref_pipeline.resolve_passes(level=3),
                                  {}, ref_pipeline.DeviceSpec(), False)
    # the same fingerprint, pass names and options; verify last in both
    assert len(ref) == len(off) and (ref[0], ref[2]) == (off[0], off[2])
    assert [n for n, _ in ref[1]] == [n for n, _ in off[1]]
    assert ref[-1] is False


@pytest.mark.parametrize("mode", ["vanilla", "ho", "xenos"])
def test_optimize_for_mode_takes_verify(mode):
    """``optimize_for_mode(..., verify=)`` as the reference's: the same
    op counts either way, the report's ``verified`` flags following."""
    counts = {}
    for verify in (True, False):
        port_pipeline.clear_optimize_cache()
        ref_pipeline.clear_optimize_cache()
        out, rep = port_pipeline.optimize_for_mode(
            port_zoo.build("mobilenet"), mode, verify=verify)
        rout, rrep = ref_pipeline.optimize_for_mode(
            ref_zoo.build("mobilenet"), mode, verify=verify)
        assert out.num_ops() == rout.num_ops()
        assert [r.verified for r in rep.passes] == \
            [r.verified for r in rrep.passes] == [verify] * len(rep.passes)
        counts[verify] = out.num_ops()
    assert counts[True] == counts[False]


def _counts(text: str) -> dict:
    """The quickstart's CNN lines: op counts, linked ops, link groups,
    the PassReport's node and edge deltas."""
    m = re.search(r"model=(\w+): (\d+) ops -> (\d+) ops", text)
    linked = re.search(r"fused/linked ops: (\[.*\])", text).group(1)
    groups = int(re.search(r"link groups: (\d+)", text).group(1))
    passes = re.findall(r"^\s+(\w+)\s+[\d.]+ ms\s+nodes\s+(\d+) ->\s+(\d+)"
                        r"\s+edges\s+(\d+) ->\s+(\d+)", text, re.M)
    return {"model": m.group(1), "ops": (int(m.group(2)), int(m.group(3))),
            "linked": linked, "groups": groups, "passes": passes}


def test_quickstart_matches_the_reference_quickstart(capsys):
    """``launch/quickstart.py --device cpu`` runs to ``quickstart OK``
    (vanilla == xenos, one train step, eight greedy decode steps), and
    its CNN side prints the reference quickstart's numbers for MobileNet:
    43 -> 17 ops, 13 ``cbr``, 6 link groups, the same pass deltas."""
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("quickstart OK")
    assert re.search(r"one train step: loss=\d+\.\d+", out)
    decoded = re.search(r"greedy decode after prefill: \[(.*)\]", out)
    assert len(decoded.group(1).split(",")) == 8

    spec = importlib.util.spec_from_file_location(
        "reference_quickstart", ROOT / "examples" / "quickstart.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref.cnn_side()
    want = _counts(buf.getvalue())
    got = _counts(out)
    assert got == want
    assert want["ops"] == (43, 17) and want["groups"] == 6
