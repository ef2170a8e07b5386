"""Sharded training on the port: the train step over DTensor on 4 gloo
ranks on the host, a ``("data", "model") = (2, 2)`` mesh, against the
port's one-device step and the reference's sharded step.

The ranks are spawned once (``launch.mesh.spawn_ranks(...,
train_shape=)``, bodies in ``test_torch_ranks.train_mesh_rank``: no jax
there) and run every case in that one rank set; the reference's
sharded steps (``train_step(batch_axes=("data",))`` over
``make_debug_mesh(4)``) run once, in a subprocess with 4 host devices
(``conftest.run_multidevice``).  Reduced configs, a global batch of 4 x
16 rows split over ``"data"``, three steps at the lr of
``test_torch_train.py``.  Reduced olmoe draws its attention at one
layer's fan-in (``test_torch_train.py``'s reason).  The reference's
sharded MoE block leaves out the sum over ``"model"`` of its router's
and tokens' cotangents (ROADMAP queue 3), so the port's sharded MoE is
held to the reference's sharded forward and to one device's gradients.

Tolerances: the loss and grad norm within rtol 1e-5 of the port's one
device (the sums over ranks run in another order) and 2e-4 of the
reference's sharded step (``tests/test_distributed.py``'s bound); the
params by ``test_torch_train._close_params``; every leaf a mesh dim
replicates, and every metric, bit-equal on every rank.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import test_torch_ranks as R
from conftest import run_multidevice
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as train_cli
from repro_torch.models.layers import cross_entropy, embed_lookup
from repro_torch.models.model import Model
from repro_torch.optim import cosine_schedule
from test_torch_train import SCHED, _close_params

STEPS, B, S = 3, 4, 16
SHAPE = mesh_lib.make_debug_mesh(4)          # data 2 x model 2
COORDS = [(r // 2, r % 2) for r in range(4)]
SEED = 3

_REFERENCE = """
import dataclasses, json, numpy as np, jax, jax.numpy as jnp
from functools import partial
from repro.configs.base import get_config
from repro.launch import mesh as mesh_lib
from repro.models import moe as M
from repro.models.model import Model, TrainState
from repro.optim import adamw_init, cosine_schedule

def flat(tree, path=""):
    if isinstance(tree, dict):
        out = {{}}
        for k, v in tree.items():
            out.update(flat(v, f"{{path}}/{{k}}"))
        return out
    return {{path: np.asarray(tree)}}

inputs = dict(np.load({inp!r}))
mesh = mesh_lib.make_debug_mesh(4)
sched = partial(cosine_schedule, **{sched!r})
out, metrics = {{}}, {{}}
for arch in ("qwen3-1.7b", "olmoe-1b-7b"):
    cfg = get_config(arch).reduced()
    m = Model(cfg, mesh=mesh)
    params = m.init(jax.random.key(0))
    batches = [{{k: jnp.asarray(inputs[f"{{arch}}/{{i}}/{{k}}"])
                for k in ("tokens", "labels")}} for i in range({steps})]
    if arch == "olmoe-1b-7b":      # attention at one layer's fan-in
        L, d = cfg.n_layers, cfg.d_model
        attn = dict(params["layers"]["attn"])
        for k in ("wq", "wk", "wv"):
            attn[k] = attn[k] * np.sqrt(L / d)
        attn["wo"] = attn["wo"] * np.sqrt(L / (cfg.n_heads
                                              * cfg.resolved_head_dim))
        params = {{**params, "layers": {{**params["layers"], "attn": attn}}}}
    out.update({{f"{{arch}}/init{{k}}": v for k, v in flat(params).items()}})
    with mesh_lib.set_mesh(mesh):
        if arch == "olmoe-1b-7b":  # the forward alone (the losses)
            loss = jax.jit(lambda p, b: m.loss_fn(p, b, ("data",))[0])
            metrics[arch] = {{"loss": [float(loss(params, b))
                                      for b in batches[:2]]}}
            continue
        state = TrainState(params, adamw_init(params, m.opt_cfg),
                           jnp.zeros((), jnp.int32))
        step = jax.jit(lambda s, b: m.train_step(
            s, b, batch_axes=("data",), lr_schedule=sched))
        losses, gnorms = [], []
        for b in batches:
            state, met = step(state, b)
            losses.append(float(met["loss"]))
            gnorms.append(float(met["grad_norm"]))
    metrics[arch] = {{"loss": losses, "grad_norm": gnorms}}
    out.update({{f"{{arch}}/final{{k}}": v
                for k, v in flat(state.params).items()}})
cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                          capacity_factor={cf_drop!r})
p = {{k: jnp.asarray(inputs[f"moe/p/{{k}}"])
     for k in ("router", "gate", "up", "down")}}
with mesh_lib.set_mesh(mesh):
    out["moe/out"] = np.asarray(jax.jit(lambda p, x: M.moe_block(
        p, x, cfg=cfg, mesh=mesh, batch_axes=("data",))[0])(
            p, jnp.asarray(inputs["moe/x"])))
np.savez({outp!r}, **out)
print("REFERENCE " + json.dumps(metrics))
"""

#: the capacity factors of the MoE block case: one that drops (the
#: sorted cut on each rank's experts), one that keeps every assignment
CF_DROP, CF_ALL = 0.5, 8.0


def _batches(cfg, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg.vocab, (B, S + 1))
        out.append({"tokens": toks[:, :-1].astype(np.int32),
                    "labels": toks[:, 1:].astype(np.int32)})
    return out


def _nest(flat: dict, prefix: str) -> dict:
    """``{prefix + "/a/b": x}`` -> ``{"a": {"b": x}}``."""
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _flat(tree, path="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


def _cfg(arch: str, **over):
    return dataclasses.replace(get_config(arch).reduced(), **over)


CASES = {"qwen3": ("qwen3-1.7b", {}), "olmoe8": ("olmoe-1b-7b",
                                                 {"capacity_factor": 8.0}),
         "olmoe": ("olmoe-1b-7b", {}),
         "qwen3_mb": ("qwen3-1.7b", {"microbatch": 2})}


def _moe_case() -> dict:
    cfg = _cfg("olmoe-1b-7b")
    rng = np.random.default_rng(11)
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {"kind": "moe", "cfg": dataclasses.asdict(cfg),
            "cf_drop": CF_DROP, "cf_all": CF_ALL,
            "p": {"router": normal(d, E), "gate": normal(E, d, ff, scale=.05),
                  "up": normal(E, d, ff, scale=.05),
                  "down": normal(E, ff, d, scale=.05)},
            "x": normal(4, 8, d), "w": normal(4, 8, d)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(the reference's metrics by arch, its arrays: init and final params
    by arch as nested numpy dicts, the MoE block's output)."""
    d = tmp_path_factory.mktemp("train_mesh")
    inp, outp = d / "in.npz", d / "out.npz"
    moe = _moe_case()
    np.savez(inp, **{f"{arch}/{i}/{k}": v
                     for arch in ("qwen3-1.7b", "olmoe-1b-7b")
                     for i, b in enumerate(_batches(_cfg(arch), SEED))
                     for k, v in b.items()},
             **{f"moe/p/{k}": v for k, v in moe["p"].items()},
             **{"moe/x": moe["x"]})
    out = run_multidevice(_REFERENCE.format(inp=str(inp), outp=str(outp),
                                            sched=SCHED, steps=STEPS,
                                            cf_drop=CF_DROP), n_devices=4)
    line = next(x for x in out.splitlines() if x.startswith("REFERENCE "))
    arrays = dict(np.load(outp))
    params = {f"{arch}/{when}": _nest(arrays, f"{arch}/{when}")
              for arch in ("qwen3-1.7b", "olmoe-1b-7b")
              for when in ("init", "final")}
    params["moe/out"] = arrays["moe/out"]
    return json.loads(line[len("REFERENCE "):]), params


def _vocab_case() -> dict:
    rng = np.random.default_rng(7)
    V, padded, d = 13, 16, 6
    labels = rng.integers(0, V, (4, 5))
    labels[0, 1] = labels[3, 4] = -1          # masked positions
    return {"kind": "vocab", "vocab": V,
            "table": rng.normal(size=(padded, d)).astype(np.float32),
            "ids": rng.integers(0, V, (4, 5)),
            "emb_weight": rng.normal(size=(4, 5, d)).astype(np.float32),
            "logits": rng.normal(size=(4, 5, padded)).astype(np.float32),
            "labels": labels}


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    """Every case on one set of 4 gloo ranks: the three train runs from
    the reference's init, the vocabulary-parallel forms, the placed init
    and moments."""
    _, ref_params = reference
    cases = {"vocab": _vocab_case(), "moe": _moe_case(),
             "placement": {"kind": "placement", "seed": SEED,
                           "cfg": dataclasses.asdict(_cfg("qwen3-1.7b"))}}
    for name, (arch, over) in CASES.items():
        cases[name] = {"kind": "train",
                       "cfg": dataclasses.asdict(_cfg(arch, **over)),
                       "params": ref_params[f"{arch}/init"],
                       "batches": _batches(_cfg(arch), SEED),
                       "sched": SCHED, "batch_axes": ("data",)}
    return mesh_lib.spawn_ranks(R.train_mesh_rank, 4, args=(cases,),
                                devices=["cpu"] * 4, timeout_s=600.0,
                                store_dir=tmp_path_factory.mktemp("store"),
                                train_shape=SHAPE)


@pytest.fixture(scope="module")
def one_device(reference):
    """The port's one-device steps of the qwen3 and cf-8 olmoe cases:
    (losses, grad norms, final params as a flat numpy dict)."""
    _, ref_params = reference
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    out = {}
    try:
        for name in ("qwen3", "olmoe8", "qwen3_mb"):
            arch, over = CASES[name]
            cfg = _cfg(arch, **over)
            model = Model(cfg, device="cpu")
            state = model.init_train_state(None, params=params_from_numpy(
                ref_params[f"{arch}/init"], "cpu"))
            losses, gnorms = [], []
            for b in _batches(cfg, SEED):
                state, met = model.train_step(
                    state, b, lr_schedule=lambda s: cosine_schedule(
                        s, **SCHED))
                losses.append(float(met["loss"]))
                gnorms.append(float(met["grad_norm"]))
            out[name] = (losses, gnorms, {
                k: v.detach().numpy() for k, v in
                _flat(state.params).items()})
    finally:
        torch.set_num_threads(n)
    return out


def _assemble(ranks: list, path: str) -> np.ndarray:
    """A leaf's whole value from the 4 ranks' local shards and
    placements: shards of mesh dim 1 joined inside those of mesh dim 0
    (DTensor's split order)."""
    pls = ranks[0]["placements"][path]

    def dim_of(p):
        return int(p[p.index("(dim=") + 5:-1]) if p.startswith("Shard") \
            else None

    def build(md, coord):
        if md == 2:
            r = COORDS.index(tuple(coord))
            return ranks[r]["params"][path]
        d = dim_of(pls[md])
        if d is None:
            return build(md + 1, coord + [0])
        return np.concatenate([build(md + 1, coord + [c]) for c in (0, 1)],
                              axis=d)
    return build(0, [])


def _lr_sum() -> float:
    return sum(float(cosine_schedule(i, **SCHED)) for i in range(STEPS))


def test_qwen3_equals_one_device_and_reference(port, one_device, reference):
    """Reduced qwen3, 3 steps on (2, 2): the loss and grad norm within
    rtol 1e-5 of the port's one-device step and 2e-4 of the reference's
    sharded step, the same bits on every rank; the params within
    ``_close_params`` of both."""
    ref_metrics, ref_params = reference
    ranks = [r["qwen3"] for r in port]
    losses, gnorms, params = one_device["qwen3"]
    for r in ranks:
        assert r["loss"].tobytes() == ranks[0]["loss"].tobytes()
        assert r["grad_norm"].tobytes() == ranks[0]["grad_norm"].tobytes()
    np.testing.assert_allclose(ranks[0]["loss"], losses, rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["grad_norm"], gnorms, rtol=1e-5)
    ref = ref_metrics["qwen3-1.7b"]
    np.testing.assert_allclose(ranks[0]["loss"], ref["loss"], rtol=2e-4)
    np.testing.assert_allclose(ranks[0]["grad_norm"], ref["grad_norm"],
                               rtol=2e-4)
    paths = sorted(params)
    got = [torch.from_numpy(_assemble(ranks, p)) for p in paths]
    _close_params([params[p] for p in paths], got, _lr_sum())
    want = _flat(ref_params["qwen3-1.7b/final"])
    _close_params([want[p] for p in paths], got, _lr_sum())


@pytest.mark.parametrize("case", sorted(CASES))
def test_replicated_leaves_bit_equal_across_ranks(port, case):
    """Every leaf on the ranks that share its shard (the coordinates of the
    mesh dims that replicate it differ alone) holds the same bits, and
    its placements are its spec's."""
    ranks = [r[case] for r in port]
    model = Model(_cfg(CASES[case][0]), mesh=SHAPE, device="cpu")
    specs = _flat(model.partition_specs())
    for path, pls in ranks[0]["placements"].items():
        sharded = [md for md, p in enumerate(pls) if p.startswith("Shard")]
        assert [md for md, name in enumerate(SHAPE.axis_names)
                if name in str(specs[path])] == sharded, path
        for r in range(4):
            for q in range(r + 1, 4):
                if all(COORDS[r][md] == COORDS[q][md] for md in sharded):
                    assert ranks[r]["params"][path].tobytes() \
                        == ranks[q]["params"][path].tobytes(), (path, r, q)


def test_olmoe_grad_norm_equals_one_device_at_cf8(port, one_device):
    """Reduced olmoe at capacity factor 8 (nothing dropped): the sharded
    grad norm equals one device's.  Before the router's and experts'
    gradients were summed over ``"data"`` (``grad_placements`` in
    ``moe._moe_expert_parallel``) it came out about half."""
    ranks = [r["olmoe8"] for r in port]
    losses, gnorms, params = one_device["olmoe8"]
    for r in ranks:
        assert r["grad_norm"].tobytes() == ranks[0]["grad_norm"].tobytes()
    np.testing.assert_allclose(ranks[0]["loss"], losses, rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["grad_norm"], gnorms, rtol=1e-5)
    paths = sorted(params)
    _close_params([params[p] for p in paths],
                  [torch.from_numpy(_assemble(ranks, p)) for p in paths],
                  _lr_sum())


def test_microbatched_step_equals_one_device(port, one_device):
    """Microbatch 2 of the batch of 4: each rank's two rows taken one a
    microbatch (the slices group other rows than one device's, the same
    mean: every label counts) — the loss and grad norm within rtol 1e-5
    of the one-device microbatched step, the same bits on every rank."""
    ranks = [r["qwen3_mb"] for r in port]
    losses, gnorms, params = one_device["qwen3_mb"]
    for r in ranks:
        assert r["loss"].tobytes() == ranks[0]["loss"].tobytes()
        assert r["grad_norm"].tobytes() == ranks[0]["grad_norm"].tobytes()
    np.testing.assert_allclose(ranks[0]["loss"], losses, rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["grad_norm"], gnorms, rtol=1e-5)
    paths = sorted(params)
    _close_params([params[p] for p in paths],
                  [torch.from_numpy(_assemble(ranks, p)) for p in paths],
                  _lr_sum())


def test_olmoe_default_capacity_equals_reference(port, reference):
    """Reduced olmoe at its capacity factor 1.25 (each rank's sorted cut
    over its experts and local tokens): the losses of the first two
    steps, forwards at the reference's weights (the first step's lr is
    0), within 2e-4 of the reference's sharded forward.  Its sharded
    gradient is not the reference's: the reference's sharded MoE block
    leaves out the sum over ``"model"`` of the router's and the tokens'
    cotangents (ROADMAP queue 3), so the port's steps are held to its
    one-device step instead (the cf-8 case)."""
    ref_metrics, _ = reference
    ranks = [r["olmoe"] for r in port]
    for r in ranks:
        assert r["loss"].tobytes() == ranks[0]["loss"].tobytes()
        assert np.isfinite(r["grad_norm"]).all()
    np.testing.assert_allclose(ranks[0]["loss"][:2],
                               ref_metrics["olmoe-1b-7b"]["loss"], rtol=2e-4)


def test_moe_block_sorted_cut_and_gradients(port, reference):
    """``moe_block`` on the mesh: at capacity factor 0.5 (assignments
    dropped: the output differs from the one keeping them all) the
    reference's sharded block, at its test's bound; at 8 the value and
    the gradients of the router, the experts and the tokens those of the
    one-device oracle (``moe_reference``)."""
    from repro_torch.models.moe import moe_reference

    _, arrays = reference
    case = _moe_case()
    p = {k: torch.tensor(v, requires_grad=True) for k, v in case["p"].items()}
    x = torch.tensor(case["x"], requires_grad=True)
    cfg = _cfg("olmoe-1b-7b", capacity_factor=CF_ALL)
    y = moe_reference(p, x, cfg=cfg)
    (y * torch.as_tensor(case["w"])).sum().backward()
    want = {**{k: t.grad.numpy() for k, t in p.items()}, "x": x.grad.numpy()}
    for r in port:
        got = r["moe"]
        np.testing.assert_allclose(got["cf_drop"], arrays["moe/out"],
                                   rtol=2e-4, atol=2e-5)
        assert not np.allclose(got["cf_drop"], got["cf_all"], atol=1e-3)
        np.testing.assert_allclose(got["cf_all"], y.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        for k, g in want.items():
            np.testing.assert_allclose(got["grads"][k], g, rtol=1e-5,
                                       atol=1e-5 * np.abs(g).max(),
                                       err_msg=k)


def test_vocab_parallel_forms_equal_one_device(port):
    """``embed_lookup`` over a table sharded on its rows (the vocabulary)
    over ``"model"`` and ``cross_entropy`` over logits sharded (batch,
    -, vocab) over (data, model), padded vocabulary and masked labels
    included: the values and both gradients equal the one-device forms'
    (the lookup's exactly: one rank's row a position)."""
    case = _vocab_case()
    table = torch.tensor(case["table"], requires_grad=True)
    logits = torch.tensor(case["logits"], requires_grad=True)
    emb = embed_lookup(table, torch.as_tensor(case["ids"]), torch.float32)
    ce = cross_entropy(logits, torch.as_tensor(case["labels"]),
                       case["vocab"])
    (emb * torch.as_tensor(case["emb_weight"])).sum().backward()
    ce.backward()
    for r in port:
        got = r["vocab"]
        np.testing.assert_array_equal(got["emb"], emb.detach().numpy())
        assert got["emb_placements"] == ["Shard(dim=0)", "Replicate()"]
        np.testing.assert_allclose(got["table_grad"], table.grad.numpy(),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got["ce"], ce.detach().numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(got["logits_grad"], logits.grad.numpy(),
                                   rtol=1e-5, atol=1e-8)
    assert len({r["vocab"]["ce"].tobytes() for r in port}) == 1


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_init_placed_by_opt_partition_specs(port, moment_dtype):
    """``adamw_init`` on DTensor params: each moment (an int8 one's ``q``
    and ``scale``) placed as ``opt_partition_specs`` says, its local
    shards the zero moment's (``scale`` 1e-12), step 0."""
    for r in port:
        got = r["placement"]["moments"][moment_dtype]
        assert got["placements"] == r["placement"]["specs"][moment_dtype]
        assert got["step"] == 0
        for key in ("m", "v"):
            for path, a in got[key].items():
                fill = np.float32(1e-12) if path.endswith(".scale") else 0
                assert (a == fill).all(), (key, path)
    if moment_dtype == "int8":
        pls = port[0]["placement"]["moments"]["int8"]["placements"]
        # gate (L, d, ff): ff split over model, each row's scale whole;
        # down (L, ff, d): its scale keeps the ff split
        assert pls["/m/layers/mlp/gate.q"][1] == "Shard(dim=2)"
        assert pls["/m/layers/mlp/gate.scale"] == ["Replicate()"] * 2
        assert pls["/m/layers/mlp/down.scale"][1] == "Shard(dim=1)"


def test_init_shards_equal_one_device_slices(port):
    """``Model.init`` on the mesh: each rank's local shard of every leaf
    is the matching slice of the one-device init from the same seed, bit
    for bit, and no rank holds more than its shard."""
    cfg = _cfg("qwen3-1.7b")
    whole = _flat(Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(SEED)))
    ranks = [r["placement"] for r in port]
    for path, t in whole.items():
        np.testing.assert_array_equal(_assemble(ranks, path), t.numpy(),
                                      err_msg=path)
        n = 2 ** sum(p.startswith("Shard")
                     for p in ranks[0]["placements"][path])
        assert all(r["params"][path].size * n == t.numel() for r in ranks)


def test_train_command_on_host_ranks(capfd, tmp_path):
    """``launch/train.py --mesh single --ranks 2 --device cpu`` (a (2, 1)
    mesh, cheaper than the 4-rank run): rank 0 alone prints the
    reference's lines with ``devices=2``, finite losses; ``--ckpt-dir``
    writes the whole params, gathered, in the reference's layout."""
    from repro_torch.checkpoint import latest_step, load_checkpoint

    losses = train_cli.main(["--arch", "qwen3-1.7b", "--reduced", "--mesh",
                             "single", "--ranks", "2", "--device", "cpu",
                             "--steps", "2", "--batch", "8", "--seq", "16",
                             "--log-every", "1", "--rank-timeout", "300",
                             "--ckpt-dir", str(tmp_path), "--ckpt-every",
                             "2"])
    assert latest_step(tmp_path) == 2
    like = Model(_cfg("qwen3-1.7b"), device="cpu").init(
        torch.Generator().manual_seed(0))
    saved = _flat(load_checkpoint(tmp_path, 2, like))
    for path, t in _flat(like).items():
        assert saved[path].shape == t.shape and torch.isfinite(
            saved[path]).all(), path
        assert not torch.equal(saved[path], t) or path.endswith("norm"), path
    assert len(losses) == 2 and all(np.isfinite(x) for x in losses)
    out = capfd.readouterr().out.splitlines()
    assert any(line.startswith("arch=qwen3-1.7b-smoke params=")
               and line.endswith(" devices=2") for line in out)
    assert [int(x.split()[1]) for x in out if x.startswith("step ")] \
        == [0, 1]
    assert out[-1].startswith("loss ") and "improved" in out[-1]


@pytest.mark.parametrize("mesh,extra", [("single", 1), ("auto", 4)])
def test_train_command_fails_without_the_cards(mesh, extra, capsys):
    """A mesh wider than the visible cards, with no device list, prints
    ``FAIL: ...`` and exits 2 (no silent one-device run)."""
    with pytest.raises(SystemExit) as e:
        train_cli.main(["--arch", "qwen3-1.7b", "--reduced", "--mesh", mesh,
                        "--ranks", str(torch.cuda.device_count() + extra)])
    assert e.value.code == 2
    assert capsys.readouterr().err.startswith("FAIL: ")
