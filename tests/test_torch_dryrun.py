"""The fake-rank dry run, the rule autotuner and the hillclimb on the
port, against the reference's XLA dry run.

The reference lowers and compiles on 8 forced host devices (data 4 x
model 2), once, in a subprocess at module scope; the port traces one
rank of a fake group of 8.  Reduced configs at the real ``train_4k``,
``decode_32k`` and ``long_500k`` shapes.

Held exactly: the records' keys, ``params``, ``active_params`` and
``model_flops_per_device``; ``dominant`` on a 1-rank mesh at the decode
shape; zero collective bytes on 1 rank, non-zero wherever the
reference's are.  FLOPs are held to a band: torch's counter counts
matmuls and attention, XLA's cost analysis elementwise work too (the
port counts up to 20% less), and XLA counts a ``lax.scan`` body once:
past 2048 tokens both packages' attention is ``chunked_attention``, at
4096 tokens 8 x 4 blocks of 512 x 1024, of which XLA counts one block,
where the port's trace counts every block as it runs.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import run_multidevice
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.core import costmodel as cm
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import state_sharding as SS
from repro_torch.launch import autotune, dryrun, hillclimb, mesh as mesh_lib
from repro_torch.models import attention as A
from repro_torch.models import moe as PM
from repro_torch.models.model import Model

PAIRS = [("qwen3-1.7b", "train_4k"), ("olmoe-1b-7b", "decode_32k"),
         ("mamba2-370m", "long_500k")]

#: the reduced configs have 2 layers, calibrate_depth's first point: its
#: count is the unrolled 2-layer compile's (the depth-4 one is not needed)
REF_SNIPPET = f"""
import dataclasses, json, os
os.environ["REPRO_DRYRUN_DEVICES"] = "8"
from repro.launch import dryrun, mesh as mesh_lib
out = {{}}
mesh8 = mesh_lib.make_debug_mesh(8)
for arch, shape in {PAIRS!r}:
    cfg = dryrun.config_for(arch, shape).reduced()
    assert cfg.n_layers == dryrun.CAL_POINTS[0]
    lowered, compiled, model, _ = dryrun.lower_one(arch, shape, mesh8, cfg=cfg)
    rec = dryrun.analyze(arch, shape, "single", lowered, compiled, model)
    unrolled = dataclasses.replace(cfg, microbatch=0, scan_layers=False)
    _, comp, _, _ = dryrun.lower_one(arch, shape, mesh8, cfg=unrolled)
    ca = dryrun._cost_analysis(comp)
    rec["calibrated"] = {{"flops": float(ca.get("flops", 0.0))}}
    out[arch + "/" + shape] = rec
cfg = dryrun.config_for("olmoe-1b-7b", "decode_32k").reduced()
lowered, compiled, model, _ = dryrun.lower_one(
    "olmoe-1b-7b", "decode_32k", mesh_lib.make_debug_mesh(1), cfg=cfg)
out["one"] = dryrun.analyze("olmoe-1b-7b", "decode_32k", "single", lowered,
                            compiled, model)
print("RECORDS " + json.dumps(out, default=float))
"""

#: the keys the reference's run_one adds to analyze's besides
#: ``calibrated`` (the port adds ``notes``: what bytes_per_device counts,
#: the ops DTensor could not run as placed)
RUN_ONE_KEYS = {"stages", "compile_s"}
CALIBRATED_KEYS = {"flops", "bytes", "collective_bytes", "compute_s",
                   "memory_s", "collective_s", "dominant", "bound_s",
                   "useful_flops_ratio"}


@pytest.fixture(autouse=True)
def no_group_left():
    """No fake process group outlives the test that made it."""
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def ref_records():
    out = run_multidevice(REF_SNIPPET, n_devices=8)
    line = next(x for x in out.splitlines() if x.startswith("RECORDS "))
    return json.loads(line[len("RECORDS "):])


def _reduced(mp, devices: int = 8):
    mp.setenv("REPRO_DRYRUN_DEVICES", str(devices))
    orig = dryrun.config_for
    mp.setattr(dryrun, "config_for", lambda a, s: orig(a, s).reduced())


@pytest.fixture
def reduced(monkeypatch):
    _reduced(monkeypatch)


@pytest.fixture(scope="module")
def port_records():
    with pytest.MonkeyPatch.context() as mp:
        _reduced(mp)
        # the port's eager trace counts every layer: one pair calibrated
        # (its keys), the others not (the time)
        recs = {f"{a}/{s}": dryrun.run_one(a, s, "single", verbose=False,
                                           calibrate=(a == "mamba2-370m"))
                for a, s in PAIRS}
        _reduced(mp, devices=1)
        recs["one"] = dryrun.run_one("olmoe-1b-7b", "decode_32k", "single",
                                     verbose=False, calibrate=False)
    return recs


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_records_match_reference(arch, shape, ref_records, port_records):
    ref = ref_records[f"{arch}/{shape}"]
    rec = port_records[f"{arch}/{shape}"]
    extra = {"serve_plan"} if INPUT_SHAPES[shape].kind == "decode" else set()
    if "calibrated" in rec:
        assert set(rec["calibrated"]) == CALIBRATED_KEYS
    assert set(rec) - {"notes", "calibrated"} \
        == (set(ref) - {"calibrated"}) | RUN_ONE_KEYS | extra
    assert set(rec["memory"]) == set(ref["memory"])
    assert rec["notes"]["bytes_per_device"] == dryrun.BYTES_NOTE
    for key in ("params", "active_params", "model_flops_per_device"):
        assert rec[key] == ref[key], key
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    if ref["collective_bytes_per_device"] > 0:
        assert rec["collective_bytes_per_device"] > 0
    assert rec["fits_hbm"] == (rec["memory"]["peak_estimate"] < cm.HBM_BYTES)
    terms = cm.roofline(rec["flops_per_device"], rec["bytes_per_device"],
                        rec["collective_bytes_per_device"])
    assert rec["dominant"] == terms.dominant
    assert rec["bound_s"] == terms.bound_s


def _attention_flops(cfg, shape, data: int, model: int) -> float:
    """Full attention's matmul FLOPs a rank in a remat train step: QK^T and
    PV (4 B S^2 hd H a layer forward), run in the forward, again in the
    remat forward and twice in the backward."""
    B = shape.global_batch // data
    H = cfg.n_heads // model
    S = shape.seq_len
    return 4 * cfg.n_layers * 4 * B * S * S * cfg.resolved_head_dim * H


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_flops_within_band(arch, shape, ref_records, port_records):
    """Within [0.8, 1.05] of the reference's calibrated FLOPs (XLA also
    counts elementwise work), the reference's attention past 2048 tokens
    taken as the one 512 x 1024 block of 32 its scan's body counts."""
    ref = ref_records[f"{arch}/{shape}"]["calibrated"]["flops"]
    port = port_records[f"{arch}/{shape}"]["flops_per_device"]
    if INPUT_SHAPES[shape].kind == "train":
        cfg = dryrun.get_config(arch).reduced()
        attn = _attention_flops(cfg, INPUT_SHAPES[shape], 4, 2)
        assert attn < port
        port, ref = port - attn, ref - attn / 32
    assert 0.8 <= port / ref <= 1.05, (port, ref)


def test_one_rank(ref_records, port_records):
    """On one rank: the decode step's dominant term is the reference's and
    no collective is issued; at 8, collectives wherever the reference's."""
    rec, ref = port_records["one"], ref_records["one"]
    assert rec["dominant"] == ref["dominant"]
    assert rec["collective_bytes_per_device"] == 0 == \
        ref["collective_bytes_per_device"]
    assert rec["collectives"] == {}


def test_flops_per_rank_not_global():
    """An evenly sharded matmul chain: each rank counts its eighth of the
    global FLOPs (a counter over the DTensor-level ops would count them
    all), and the chain's one all-reduce."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate

    M, K, N, O = 64, 32, 48, 16
    with mesh_lib.fake_mesh(mesh_lib.make_debug_mesh(8)) as dm, \
            FakeTensorMode():
        x = torch.empty(M, K)
        w1 = torch.empty(K, N)
        w2 = torch.empty(N, O)
        xs = SS.place(x, SH.P("data", None), dm)
        w1s = SS.place(w1, SH.P(None, "model"), dm)
        w2s = SS.place(w2, SH.P("model", None), dm)
        out, trace = dryrun.trace_step(
            lambda: ((xs @ w1s) @ w2s).redistribute(
                dm, [xs.placements[0], Replicate()]),
            hold=(xs, w1s, w2s))
    assert trace.flops == (2 * M * K * N + 2 * M * N * O) / 8
    assert cm.collective_bytes_from_trace(trace.collectives) \
        == {"all-reduce": M // 4 * O * 4, "total": M // 4 * O * 4}
    assert trace.memory["argument_bytes"] == (M * K // 4 + K * N // 2
                                              + N * O // 2) * 4


def test_partitioned_index_and_scatter():
    """The dry run's own partitioning where DTensor would gather: a
    row-aligned cache read and write (each rank its rows, no
    collective), a lookup into a row-sharded table (a partial sum, one
    all-reduce of the result), and a scatter into a tensor sharded on
    the scatter dim (each rank its shard, no collective)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with mesh_lib.fake_mesh(mesh_lib.make_debug_mesh(8)) as dm, \
            FakeTensorMode():
        cache = SS.place(torch.empty(8, 16, 2, 4), SH.P("data", None,
                                                         "model", None), dm)
        new = SS.place(torch.empty(8, 2, 4), SH.P("data", "model", None), dm)
        slot = SS.place(torch.empty(8, dtype=torch.long), SH.P("data"), dm)
        table = SS.place(torch.empty(16, 6), SH.P("model", None), dm)
        ids = SS.place(torch.empty(8, 3, dtype=torch.long),
                       SH.P("data", None), dm)
        logits = SS.place(torch.empty(8, 16), SH.P("data", "model"), dm)
        src = SS.place(torch.empty(8, 1), SH.P("data", None), dm)
        idx = SS.place(torch.empty(8, 1, dtype=torch.long),
                       SH.P("data", None), dm)

        def step():
            rows = torch.arange(8)
            got = cache[rows, slot]
            cache[rows, slot] = new
            emb = table[ids]
            grad = torch.zeros_like(logits).scatter_add(-1, idx, src)
            return got, emb, grad
        (got, emb, grad), trace = dryrun.trace_step(
            step, hold=(cache, new, slot, table, ids, logits, src, idx))
    assert tuple(got.shape) == (8, 2, 4)
    assert tuple(got.to_local().shape) == (2, 1, 4)
    assert tuple(emb.to_local().shape) == (2, 3, 6)
    assert grad.placements == logits.placements
    assert trace.replicated == {}
    # the table lookup's partial sum over the model axis, summed once
    assert cm.collective_bytes_from_trace(trace.collectives) \
        == {"all-reduce": 2 * 3 * 6 * 4, "total": 2 * 3 * 6 * 4}


def test_calibrate_depth_equals_full_depth(reduced):
    """An eager trace counts every layer: on a uniform stack the
    reference's two-point extrapolation equals the full-depth count."""
    cfg = dataclasses.replace(dryrun.config_for("qwen3-1.7b", "decode_32k"),
                              n_layers=6)
    mesh = dryrun.build_mesh(False)
    cal = dryrun.calibrate_depth("qwen3-1.7b", "decode_32k", mesh, cfg=cfg)
    trace, _, _ = dryrun.lower_one("qwen3-1.7b", "decode_32k", mesh, cfg=cfg)
    coll = cm.collective_bytes_from_trace(trace.collectives)["total"]
    assert cal["flops"] == pytest.approx(trace.flops, rel=1e-12)
    assert cal["bytes"] == pytest.approx(trace.bytes, rel=1e-12)
    assert cal["collective_bytes"] == pytest.approx(coll, rel=1e-12)


def test_moe_capacity_form():
    """The dry run's routed FFN: at a capacity no expert overflows it is
    the dense oracle; its FLOPs are the k_max rows' (6 k_max d ff), where
    XLA's cost analysis of the reference's ``ragged_dot`` counts every row
    against each of the e_local + 1 groups: a ratio of 1 / (e_local + 1)
    to the reference's count."""
    import jax
    import jax.numpy as jnp
    from torch.utils.flop_counter import FlopCounterMode

    from repro.models import moe as RM

    T, d, ff, E, k = 32, 64, 96, 4, 2
    g = torch.Generator().manual_seed(0)
    p = {"router": torch.randn(d, E, generator=g),
         "gate": torch.randn(E, d, ff, generator=g) * 0.1,
         "up": torch.randn(E, d, ff, generator=g) * 0.1,
         "down": torch.randn(E, ff, d, generator=g) * 0.1}
    x = torch.randn(T, d, generator=g)
    cfg = type("C", (), {"top_k": k})()
    out = PM._moe_capacity(x, p["router"], p["gate"], p["up"], p["down"],
                           top_k=k, e_local=E, lo=0, k_max=T * k * E)
    ref = PM.moe_reference(p, x[None], cfg=cfg)[0]
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)

    e_local, t_local = 2, 32
    k_max = PM._round8(math.ceil(1.25 * t_local * k * e_local / E))
    f = jax.jit(lambda *a: RM._moe_local(
        *a, n_experts=E, top_k=k, e_local=e_local, lo=jnp.int32(0),
        k_max=k_max))
    shapes = [(t_local, d), (d, E), (e_local, d, ff), (e_local, d, ff),
              (e_local, ff, d)]
    ca = f.lower(*[jax.ShapeDtypeStruct(s, jnp.float32)
                   for s in shapes]).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    with FlopCounterMode(display=False) as fc:
        PM._moe_capacity(*[torch.randn(s) for s in shapes], top_k=k,
                         e_local=e_local, lo=0, k_max=k_max)
    assert fc.get_total_flops() == 6 * k_max * d * ff + 2 * t_local * d * E
    assert fc.get_total_flops() / ca["flops"] \
        == pytest.approx(1 / (e_local + 1), rel=0.02)


def test_to_placements_local_shard():
    """A tensor placed by a spec's placements holds, on a rank, the block
    the spec names at that rank's mesh coordinate."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    t = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    dist.init_process_group("fake", store=FakeStore(), rank=5, world_size=8)
    try:
        mesh = init_device_mesh("cpu", (4, 2),
                                mesh_dim_names=("data", "model"))
        coord = mesh.get_coordinate()   # rank 5 of (4, 2)
        assert list(coord) == [2, 1]
        for spec, block in [
                (SH.P("data", "model", None), (slice(4, 6), slice(3, 6))),
                (SH.P(None, None, "model"), (slice(None), slice(None),
                                             slice(2, 4))),
                (SH.P(("data", "model"), None, None), (slice(5, 6),)),
                # 6 rows over 4: ceiling chunks of 2, the last one empty
                (SH.P(None, "data", None), (slice(None), slice(4, 6)))]:
            dt = distribute_tensor(t, mesh, SH.to_placements(spec, mesh),
                                   src_data_rank=None)
            assert torch.equal(dt.to_local(), t[block]), spec
        with pytest.raises(ValueError, match="mesh's order"):
            SH.to_placements(SH.P(("model", "data")), mesh)
    finally:
        dist.destroy_process_group()


def test_place_value_is_distribute_tensor_at_rank_5():
    """``state_sharding.place_value`` (a whole tensor to this rank's
    shard, no collective) gives ``distribute_tensor``'s local block at
    rank 5 of a (4, 2) mesh, and ``placements_to_spec`` inverts
    ``to_placements``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    t = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    dist.init_process_group("fake", store=FakeStore(), rank=5, world_size=8)
    try:
        mesh = init_device_mesh("cpu", (4, 2),
                                mesh_dim_names=("data", "model"))
        for spec in (SH.P("data", "model", None), SH.P(None, None, "model"),
                     SH.P(("data", "model"), None, None), SH.P()):
            pls = SH.to_placements(spec, mesh)
            got = SS.place_value(t, spec, mesh)
            want = distribute_tensor(t, mesh, pls, src_data_rank=None)
            assert list(got.placements) == pls
            assert got.to_local().is_contiguous()
            assert torch.equal(got.to_local(), want.to_local()), spec
            assert got.to_local().untyped_storage().data_ptr() \
                != t.untyped_storage().data_ptr()
            assert SH.placements_to_spec(pls, 3, mesh) \
                == SH.P(*(list(spec) + [None] * (3 - len(spec))))
    finally:
        dist.destroy_process_group()


def test_vocab_parallel_lookup_and_loss_count_locally():
    """The model's embedding lookup and loss over a vocabulary sharded on
    ``"model"`` (``models.layers``' vocabulary-parallel forms), forward
    and backward, on a fake group of 8: nothing replicated, no
    all-gather (neither the table nor the logits gathered), the
    all-reduces a few rows' scalars and the lookup's output; the lookup's
    accumulating backward writes the rank's own rows (its gradient the
    shard's shape)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models.layers import cross_entropy, embed_lookup

    with mesh_lib.fake_mesh(mesh_lib.make_debug_mesh(8)) as dm, \
            FakeTensorMode():
        table = SS.place(torch.empty(16, 6), SH.P("model", None), dm
                         ).requires_grad_(True)
        logits = SS.place(torch.empty(8, 3, 16), SH.P("data", None, "model"),
                          dm).requires_grad_(True)
        ids = SS.place(torch.empty(8, 3, dtype=torch.long),
                       SH.P("data", None), dm)
        labels = SS.place(torch.empty(8, 3, dtype=torch.long),
                          SH.P("data", None), dm)

        def step():
            emb = embed_lookup(table, ids, torch.float32)
            gt, gl = torch.autograd.grad(
                emb.sum() + cross_entropy(logits, labels, 13),
                (table, logits))
            return emb, gt, gl
        (emb, gt, gl), trace = dryrun.trace_step(
            step, hold=(table, logits, ids, labels))
    assert trace.replicated == {}
    assert tuple(emb.to_local().shape) == (2, 3, 6)
    assert tuple(gt.to_local().shape) == (8, 6)      # the rank's rows
    assert list(gl.placements) == list(logits.placements)
    kinds = {k for k, _ in trace.collectives}
    assert kinds == {"all_reduce"}, kinds
    # the lookup's (2, 3, 6) output is the largest thing summed
    assert max(b for _, b in trace.collectives) == 2 * 3 * 6 * 4


def test_qwen3_train_record_is_pinned(monkeypatch):
    """Full-width qwen3-1.7b ``train_4k`` on one rank of the 16 x 16 mesh:
    the record phase 8 prints, pinned (FLOPs, collective bytes by kind,
    peak).  Nothing is replicated: the embedding gradient's accumulating
    write is the rank's own (before the vocabulary-parallel lookup, torch
    2.11 found no DTensor strategy for it and replicated it: 1.791e11
    collective bytes against 1.661e11 on 2.13), the loss reduces rows'
    scalars and the attention runs on each rank's heads, through the
    chunked scan at 4096 tokens.  The 8 kv heads do not split 16 ways:
    their projections split d instead, and each rank computes its own d
    rows of their weight gradients from the cotangent summed over
    ``"model"`` (an all-reduce of the rank's slice, before the
    projection), not the whole weights' on every rank (8.0771e13 FLOPs
    before, 1.4431e13 more: 15/16 of 28 layers x 2 x 2 x 65,536 tokens x
    2048 x 1024)."""
    monkeypatch.delenv("REPRO_DRYRUN_DEVICES", raising=False)
    rec = dryrun.run_one("qwen3-1.7b", "train_4k", "single", verbose=False,
                         calibrate=False)
    assert rec["flops_per_device"] == 66340064854016.0
    assert 80771154968576.0 - rec["flops_per_device"] == \
        28 * 2 * 2 * 65536 * 2048 * 1024 * 15 / 16
    assert rec["collectives"] == {"all-reduce": 68745041928.0,
                                  "all-gather": 15032385536.0}
    assert rec["collective_bytes_per_device"] == 83777427464.0
    assert rec["memory"]["peak_estimate"] == 16153231372
    assert rec["notes"]["replicated_ops"] == {}


def test_qwen3_embed_fsdp_decode_record_is_pinned(monkeypatch):
    """``tune``'s ``embed_fsdp`` candidate at qwen3-1.7b ``decode_32k`` on
    the 16 x 16 mesh, pinned, beside the baseline's record (the ranking
    phase 8 prints, the same on the card machine's torch).  Three things
    made it depend on the torch version: the embedding lookup of a
    table whose columns sit on ``"data"`` (DTensor's own indexing: 2.13
    kept the columns split and the batch whole, 2.11 gathered the
    table), now the vocabulary-parallel lookup after gathering the
    columns; a matmul whose weight is split on the mesh dim that splits
    its rows (2.13 gathered the weight, 2.11 the rows), now the weight
    gathered (FSDP); and the bytes of ``prim.device`` queries (about
    half the record's bytes, a count that differs by version), now not
    counted.  Before: 7.630 ms on 2.13, 8.772 on 2.11."""
    monkeypatch.delenv("REPRO_DRYRUN_DEVICES", raising=False)
    rec = autotune.score("qwen3-1.7b", "decode_32k", "single",
                         autotune.CANDIDATE_RULESETS["embed_fsdp"])
    assert rec["bound_s"] == 0.003918249346865672
    assert rec["flops_per_device"] == 7240417280.0
    assert rec["bytes_per_device"] == 13126135312.0
    assert rec["collectives"] == {"all-gather": 514297856.0,
                                  "all-reduce": 236781568.0}
    assert rec["memory"]["peak_estimate"] == 2196448672
    base = autotune.score("qwen3-1.7b", "decode_32k", "single", {})
    assert base["bytes_per_device"] == 13313037072.0
    assert base["bound_s"] == 0.003974040917014926 > rec["bound_s"]


def test_fake_mesh_lifetime():
    """The fake group lives inside the context only, on error too, and
    cannot be opened inside another group."""
    with mesh_lib.fake_mesh(mesh_lib.make_debug_mesh(8)) as dm:
        assert dist.get_world_size() == 8 and tuple(dm.shape) == (4, 2)
        with pytest.raises(RuntimeError, match="already"):
            with mesh_lib.fake_mesh(mesh_lib.make_debug_mesh(2)):
                pass
    assert not dist.is_initialized()
    with pytest.raises(KeyError):
        with mesh_lib.fake_mesh(mesh_lib.make_production_mesh()):
            raise KeyError("inside")
    assert not dist.is_initialized()


def test_clis_tune_and_hillclimb(reduced, tmp_path, capsys):
    """``dryrun``, ``autotune`` (``tune``: Algorithm 1 over the seven rule
    sets, one pass record a candidate) and ``hillclimb`` (``run_pair``)
    end to end on reduced archs, each writing the reference's JSON."""
    out = tmp_path / "dry.jsonl"
    dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k",
                 "--out", str(out)])
    assert "all dry-runs passed" in capsys.readouterr().out
    assert json.loads(out.read_text())["shape"] == "long_500k"

    out = tmp_path / "tune.jsonl"
    autotune.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k",
                   "--out", str(out)])
    line = json.loads(out.read_text())
    assert set(line) == {"arch", "shape", "mesh", "best", "results",
                         "report"}
    assert set(line["results"]) == set(autotune.CANDIDATE_RULESETS)
    assert line["best"] in autotune.CANDIDATE_RULESETS
    assert len(line["report"]["passes"]) == 7
    best = line["results"][line["best"]]["bound_s"]
    assert all(math.isfinite(r["bound_s"]) and r["bound_s"] >= best
               for r in line["results"].values())
    assert "best scheme:" in capsys.readouterr().out

    out = tmp_path / "hill.jsonl"
    hillclimb.main(["--pair", "chameleon_decode", "--out", str(out)])
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["variant"] for r in recs] == ["baseline", "kv_replicated",
                                            "cache_seq_shard"]
    for r in recs:
        assert "error" not in r and r["calibrated"]["bound_s"] > 0


def test_tune_scores_a_failing_candidate_inf(reduced, monkeypatch):
    """A rule set whose trace raises scores +inf with its error, and
    Algorithm 1 passes over it."""
    real = autotune.score

    def score(arch, shape, mesh_name, rules):
        if rules.get("boom"):
            raise RuntimeError("no sharding strategy")
        return real(arch, shape, mesh_name, rules)
    monkeypatch.setattr(autotune, "score", score)
    best, results, report = autotune.tune(
        "mamba2-370m", "long_500k", rulesets={"bad": {"boom": 1}, "ok": {}})
    assert best == "ok"
    assert results["bad"]["bound_s"] == float("inf")
    assert results["bad"]["error"] == "RuntimeError: no sharding strategy"
    assert report.passes[0].summary["error"] == results["bad"]["error"]
    assert math.isfinite(results["ok"]["bound_s"])


def test_collective_bytes_from_trace_matches_hlo_parser():
    """The trace's collectives sum like the reference's HLO parser."""
    from repro.core.costmodel import collective_bytes_from_hlo

    hlo = "\n".join([
        "  %ar = f32[16,16]{1,0} all-reduce(f32[16,16]{1,0} %x), to_apply=%s",
        "  %ag = bf16[8,128]{1,0} all-gather(bf16[2,128]{1,0} %y)",
        "  ROOT %rs = f32[4]{0} reduce-scatter(f32[16]{0} %z)",
        "  %ar2 = f32[8]{0} all-reduce(f32[8]{0} %w)"])
    events = [("all_reduce", 16 * 16 * 4), ("all_gather_into_tensor",
                                            8 * 128 * 2),
              ("reduce_scatter_tensor", 16), ("all_reduce", 32)]
    assert cm.collective_bytes_from_trace(events) \
        == collective_bytes_from_hlo(hlo)


def test_roofline_terms_match_reference():
    from repro.core.costmodel import RooflineTerms as RefTerms

    rng = np.random.default_rng(0)
    for _ in range(50):
        c, m, k = (float(v) for v in rng.exponential(size=3))
        port, ref = cm.RooflineTerms(c, m, k), RefTerms(c, m, k)
        assert port.as_dict() == ref.as_dict()
        assert port.serial_s == ref.serial_s


def test_fake_leaves_bypass_the_layer_memo_and_rope_memo(reduced,
                                                      monkeypatch):
    """The dry run's fake and DTensor leaves never enter
    ``Model._layers``' memo, and no fake RoPE table is memoized: a real
    step after a trace reads real tensors, and a trace after a real step
    reads the real table."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = dryrun.config_for("qwen3-1.7b", "decode_32k")
    m = Model(cfg, device="cpu")
    fm = FakeTensorMode()
    params = m.abstract(fm)
    with fm:
        views = m._layers(params)
    assert len(views) == cfg.n_layers and m._views == {}
    monkeypatch.setattr(A, "_INV_FREQ", {})
    mesh = dryrun.build_mesh(False)
    dryrun.lower_one("qwen3-1.7b", "decode_32k", mesh)
    assert A._INV_FREQ == {}
    inv = A.rope_frequencies(cfg.resolved_head_dim, cfg.rope_fraction,
                             cfg.rope_theta, "cpu")
    assert type(inv) is torch.Tensor and list(A._INV_FREQ.values()) == [inv]
    dryrun.lower_one("qwen3-1.7b", "decode_32k", mesh)
    assert list(A._INV_FREQ.values()) == [inv]
