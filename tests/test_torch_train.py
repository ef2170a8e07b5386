"""The port's training against the JAX reference, on the CPU.

The optimizer (``adamw_update`` in its three moment precisions,
``cosine_schedule``), the loss (``cross_entropy``, ``Model.loss_fn`` and
its gradient leaf by leaf) and three ``train_step``s from one state, for
a dense, a layer-pattern, an MoE, an SSM, a hybrid and an
encoder-decoder reduced config; microbatched ≡ full batch; remat on ≡
off bit for bit; the reference's optimizer and convergence cases on the
port; and the repairs training needed (fresh per-layer views under grad,
kernel wrappers that refuse inputs requiring grad, ``cast_params``
detaching a train state's leaves, ``loss_fn`` under a ``cuda`` plan).

Weights come from ``repro`` ``Model.init`` and cross through numpy
(``repro_torch.convert``).  Reduced olmoe, hymba and seamless draw their
attention at one layer's fan-in: at the reference's raw init (a stacked
leaf's fan-in is its layer axis) they attend one-hot, and the gradient
through a one-hot softmax moves past any tolerance under a last-bit
change of the scores (olmoe at its raw init: 1.7e-3 of a leaf's largest
gradient).

Tolerances.  Adam divides each element's step by that element's own
RMS, so an element whose gradient lies within the two packages'
agreement (~1e-6 of its leaf's largest) of zero may take a step of any
size up to lr in either.  The params after ``train_step`` are held at
the starting tolerance (1e-3 of the summed lr, plus rtol 1e-5) in all
but 0.1% of their elements, and within half the summed lr in all.
The moments of ``adamw_update`` take an atol of 1e-6 of their leaf's
largest beside rtol 1e-6: a first moment that cancels (0.9 m + 0.1 g of
opposite signs) keeps the absolute error of its terms.  The reference's
``cos`` and torch's differ by an ulp or two, so ``cosine_schedule``
agrees at rtol 1e-6, not to the bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro.models.layers import cross_entropy as jax_cross_entropy
from repro.models.model import Model as JaxModel
from repro.models.model import TrainState as JaxTrainState
from repro.optim import adamw as jax_adamw
from repro.optim import cosine_schedule as jax_cosine
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.core.pipeline import KernelPlan
from repro_torch.data import SyntheticLM, audio_batch_stub, make_train_iterator
from repro_torch.models import moe as port_moe
from repro_torch.models.layers import cross_entropy, tree_leaves
from repro_torch.models.model import Model
from repro_torch.optim import adamw as port_adamw
from repro_torch.optim import cosine_schedule
from repro_torch.serving import Request, ServingEngine

from test_torch_encdec import _per_layer_fan_in as encdec_fan_in
from test_torch_recurrent import _per_layer_fan_in as layer_fan_in

ARCHES = ("qwen3-1.7b", "gemma3-1b", "olmoe-1b-7b", "mamba2-370m",
          "hymba-1.5b", "seamless-m4t-large-v2")
B, S, SRC = 4, 16, 12
#: the lr of the parity steps (step 0 is warmup's zero)
SCHED = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)


def _batch(cfg, batch=B, seq=S, seed=0):
    """numpy tokens / labels (and an encoder-decoder's frames)."""
    if cfg.is_encoder_decoder:
        return audio_batch_stub(batch, SRC, seq, cfg.d_model, cfg.vocab,
                                seed=seed)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                (batch, seq + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _ref_params(jm):
    jcfg = jm.cfg
    jp = jm.init(jax.random.key(0))
    if jcfg.family == "audio":
        return encdec_fan_in(jp, jcfg)
    if jcfg.family in ("moe", "hybrid"):
        return layer_fan_in(jp, jcfg)
    return jp


def _port_params(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


class Pair:
    """A reduced arch in both packages: models, the reference's params,
    its jitted loss-gradient and train step."""

    def __init__(self, arch, **over):
        self.jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                                        **over)
        self.jm = JaxModel(self.jcfg)
        self.jp = _ref_params(self.jm)
        self.tm = Model(ModelConfig(**dataclasses.asdict(self.jcfg)),
                        device="cpu")
        self.grad = jax.jit(jax.value_and_grad(self.jm.loss_fn,
                                               has_aux=True))
        sched = lambda s: jax_cosine(s, **SCHED)
        self.step = jax.jit(lambda s, b: self.jm.train_step(
            s, b, lr_schedule=sched))

    def ref_state(self):
        return JaxTrainState(self.jp, jax_adamw.adamw_init(
            self.jp, self.jm.opt_cfg), jnp.zeros((), jnp.int32))


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(arch, **over):
        key = (arch, tuple(sorted(over.items())))
        if key not in cache:
            cache[key] = Pair(arch, **over)
        return cache[key]
    return get


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grads(model, params, batch):
    """The port's loss, its parts and the gradient of every leaf."""
    params = jax.tree.map(lambda t: t.detach().requires_grad_(True), params)
    loss, parts = model.loss_fn(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def _close_params(ref_leaves, port_leaves, lr_sum):
    """Every leaf within half the summed lr; all but 0.1% of the elements
    within 1e-3 of it (plus rtol 1e-5 both)."""
    off = total = 0
    for a, b in zip(ref_leaves, port_leaves):
        a = np.asarray(a)
        err = np.abs(a - b.detach().numpy()) - 1e-5 * np.abs(a)
        assert err.max() <= 0.5 * lr_sum, err.max() / lr_sum
        off += int((err > 1e-3 * lr_sum).sum())
        total += err.size
    assert off <= 1e-3 * total, (off, total)



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this module runs: its steps are many
    small ops, and beside other test workers a full pool of spinning
    threads a process slowed one convergence test from ~4 s to ~390 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# -- the optimizer ---------------------------------------------------------------

def test_cosine_schedule_matches_reference():
    """Warmup, the cosine and its floor, for int and tensor steps."""
    for peak, warm, total in ((3e-3, 5, 40), (1e-3, 20, 200), (1.0, 10, 100),
                              (3e-4, 0, 7)):
        f = jax.jit(lambda s: jax_cosine(s, peak_lr=peak, warmup_steps=warm,
                                         total_steps=total))
        for s in range(total + 3):
            want = float(f(s))
            got = cosine_schedule(torch.tensor(s, dtype=torch.int32),
                                  peak_lr=peak, warmup_steps=warm,
                                  total_steps=total)
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(want, rel=1e-6, abs=0)


def _opt_tree(rng, scale=1.0):
    """A scalar, a vector and 2-D and 3-D leaves, nested."""
    leaf = lambda *s: np.asarray(rng.normal(size=s) * scale, np.float32)
    return {"a": leaf(7, 33), "b": leaf(), "c": {"d": leaf(4, 5, 6),
                                                 "e": leaf(9)}}


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_adamw_update_matches_reference(dtype, clip, monkeypatch):
    """Three steps from one state and the same gradients: params and fp32
    moments at rtol 1e-6, bf16 moments equal as bf16, int8 ``q`` equal
    but ±1 at a rounding tie, ``scale`` at rtol 1e-6; the grad norm."""
    rng = np.random.default_rng(1)
    jcfg = jax_adamw.AdamWConfig(moment_dtype=dtype, grad_clip=clip)
    tcfg = port_adamw.AdamWConfig(moment_dtype=dtype, grad_clip=clip)
    p0 = _opt_tree(rng)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jax_adamw.adamw_init(jp, jcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p0)
    ts = port_adamw.adamw_init(tp, tcfg)
    update = jax.jit(lambda p, g, s, lr: jax_adamw.adamw_update(
        p, g, s, jcfg, lr))
    is_q = lambda x: isinstance(x, jax_adamw.QuantMoment)
    quantized = []    # the port's moments as they enter _quantize
    quantize = port_adamw._quantize

    def spy(x, sqrt_code=False):
        quantized.append((x.clone(), sqrt_code))
        return quantize(x, sqrt_code)
    monkeypatch.setattr(port_adamw, "_quantize", spy)
    for i in range(3):
        quantized.clear()
        g = _opt_tree(rng, 3.0)
        jp, js, jmet = update(jp, jax.tree.map(jnp.asarray, g), js,
                              jax_cosine(i + 1, **SCHED))
        tp, ts, tmet = port_adamw.adamw_update(
            tp, jax.tree.map(torch.from_numpy, g), ts, tcfg,
            cosine_schedule(i + 1, **SCHED))
        assert int(tmet["step"]) == int(jmet["step"]) == i + 1
        assert float(tmet["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-6)
        for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-6 * np.abs(a).max())
        ref_m = jax.tree.leaves(js.m, is_leaf=is_q) \
            + jax.tree.leaves(js.v, is_leaf=is_q)
        port_m = tree_leaves(ts.m) + tree_leaves(ts.v)
        # _quantize ran m then v of each leaf in turn
        inputs = quantized[0::2] + quantized[1::2]
        for j, (a, b) in enumerate(zip(ref_m, port_m)):
            if dtype == "int8":
                _check_quant(a, b, *inputs[j])
            elif dtype == "bfloat16":
                assert b.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    b.float().numpy(), np.asarray(a.astype(jnp.float32)))
            else:
                a = np.asarray(a)
                np.testing.assert_allclose(b.numpy(), a, rtol=1e-6,
                                           atol=1e-6 * np.abs(a).max())


def _check_quant(ref, port, x, sqrt_code):
    """int8 ``q`` equal except ±1 where t = x / scale * 127 lies within
    1e-6 (relative to max(1, |t|)) of a .5 tie, x being the fp32 moment
    the port quantized; ``scale`` at rtol 1e-6."""
    assert port.shape == ref.shape and port.q.dtype == torch.int8
    np.testing.assert_allclose(port.scale.numpy(), np.asarray(ref.scale),
                               rtol=1e-6)
    dq = port.q.numpy().astype(int) - np.asarray(ref.q).astype(int)
    assert np.abs(dq).max(initial=0) <= 1
    x = x.double()
    if sqrt_code:
        x = x.clamp(min=0).sqrt()
    t = (x.reshape(port.scale.shape[:-1] + (-1,)) / port.scale.double()
         * 127).numpy()
    dq = dq.reshape(t.shape)
    tie = np.abs(np.abs(t - np.floor(t)) - 0.5) \
        <= 1e-6 * np.maximum(1.0, np.abs(t))
    assert not (dq != 0)[~tie].any(), "int8 codes differ off a tie"


def test_quantize_matches_reference():
    """``_quantize`` / ``_dequantize``, plain and sqrt-coded, scalar and
    2-D, with exact ties (x / scale * 127 = k + 0.5 rounds to even in
    both) and zeros (the sqrt code's half-quantum floor)."""
    rng = np.random.default_rng(2)
    ties = np.array([[127.0, 0.5, 1.5, -2.5, 3.5, 0.0]], np.float32)
    for x in (ties, np.asarray(rng.normal(size=(6, 40)), np.float32),
              np.asarray(2.5, np.float32), np.abs(ties)):
        for sqrt_code in (False, True):
            jq = jax_adamw._quantize(jnp.asarray(x), sqrt_code)
            tq = port_adamw._quantize(torch.from_numpy(x.copy()), sqrt_code)
            np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
            np.testing.assert_array_equal(tq.scale.numpy(),
                                          np.asarray(jq.scale))
            np.testing.assert_array_equal(
                port_adamw._dequantize(tq, sqrt_code).numpy(),
                np.asarray(jax_adamw._dequantize(jq, sqrt_code)))


# the reference's optimizer cases (tests/test_moe_optim.py), on the port

def test_adamw_first_step_is_signed_lr():
    cfg = port_adamw.AdamWConfig(lr=1e-2, weight_decay=0.0, grad_clip=0.0)
    p = {"w": torch.ones(4)}
    g = {"w": torch.tensor([1.0, -1.0, 2.0, -0.5])}
    st = port_adamw.adamw_init(p, cfg)
    new_p, st, _ = port_adamw.adamw_update(p, g, st, cfg)
    np.testing.assert_allclose(new_p["w"].numpy(),
                               1.0 - 0.01 * np.sign([1, -1, 2, -0.5]),
                               rtol=1e-4)


def test_adamw_grad_clip():
    cfg = port_adamw.AdamWConfig(lr=1e-2, grad_clip=1.0, weight_decay=0.0)
    p = {"w": torch.zeros(1000)}
    g = {"w": torch.full((1000,), 100.0)}
    st = port_adamw.adamw_init(p, cfg)
    _, _, metrics = port_adamw.adamw_update(p, g, st, cfg)
    assert float(metrics["grad_norm"]) > 1000


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_adamw_moment_dtypes_converge(dtype):
    """All three moment precisions reduce a quadratic loss."""
    rng = np.random.default_rng(3)
    cfg = port_adamw.AdamWConfig(lr=0.05, weight_decay=0.0,
                                 moment_dtype=dtype)
    w = {"w": torch.tensor(rng.normal(size=(512,)), dtype=torch.float32)}
    st = port_adamw.adamw_init(w, cfg)
    l0 = float(0.5 * w["w"].square().sum())
    for _ in range(30):
        w, st, _ = port_adamw.adamw_update(w, {"w": w["w"].clone()}, st, cfg)
    assert float(0.5 * w["w"].square().sum()) < 0.25 * l0, dtype


def test_int8_quant_roundtrip():
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(1000,)) * 3.0, dtype=torch.float32)
    back = port_adamw._dequantize(port_adamw._quantize(x))
    assert back.shape == x.shape
    assert float((back - x).abs().max()) < float(x.abs().max()) / 127 * 1.5


def test_cosine_schedule_shape():
    s = [float(cosine_schedule(t, peak_lr=1.0, warmup_steps=10,
                               total_steps=100)) for t in range(100)]
    assert s[0] == 0.0 and abs(s[10] - 1.0) < 0.02
    assert s[99] < 0.2 and all(v >= 0 for v in s)


def test_moe_grads_flow():
    """Every MoE leaf gets a gradient, and each matches the reference's
    (tests/test_moe_optim.py's case, held against ``jax.grad``)."""
    rng = np.random.default_rng(3)
    jcfg = dataclasses.replace(jax_get_config("olmoe-1b-7b").reduced(),
                               n_experts=4, top_k=2, capacity_factor=8.0)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    d, ff = jcfg.d_model, jcfg.d_ff
    p = {"router": rng.normal(size=(d, 4)),
         "gate": rng.normal(size=(4, d, ff)) * 0.05,
         "up": rng.normal(size=(4, d, ff)) * 0.05,
         "down": rng.normal(size=(4, ff, d)) * 0.05}
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    x = np.asarray(rng.normal(size=(2, 8, d)), np.float32)
    want = jax.grad(lambda pp: jax_moe.moe_block(
        pp, jnp.asarray(x), cfg=jcfg, mesh=None)[0].sum())(
        jax.tree.map(jnp.asarray, p))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in p.items()}
    out, _ = port_moe.moe_block(tp, torch.from_numpy(x), cfg=tcfg)
    got = dict(zip(tp, torch.autograd.grad(out.sum(), list(tp.values()))))
    for k, v in got.items():
        assert float(v.abs().sum()) > 0, k
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-5 * np.abs(want[k]).max())


# -- the loss --------------------------------------------------------------------

@pytest.mark.parametrize("vocab,padded", [(500, 512), (512, 512)])
def test_cross_entropy_matches_reference(vocab, padded):
    """A padded vocabulary (entries past ``vocab`` masked) and labels of
    -1 (positions masked out of the mean), at rtol 1e-6; the gradient of
    the logits too, zero on the padding."""
    rng = np.random.default_rng(4)
    logits = np.asarray(rng.normal(size=(3, 7, padded)) * 4, np.float32)
    labels = rng.integers(0, vocab, (3, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[2, 6] = -1
    want, want_g = jax.value_and_grad(jax_cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels), vocab)
    t = torch.from_numpy(logits.copy()).requires_grad_(True)
    got = cross_entropy(t, torch.from_numpy(labels), vocab)
    (got_g,) = torch.autograd.grad(got, t)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-9)
    assert not got_g[..., vocab:].any()
    all_masked = torch.full((3, 7), -1, dtype=torch.int32)
    assert float(cross_entropy(t, all_masked, vocab).detach()) == 0.0


@pytest.mark.parametrize("arch", ARCHES)
def test_loss_and_grads_match_reference(pairs, arch):
    """``loss_fn`` at rtol 2e-5 (and its ``ce`` / ``aux``), and every
    gradient leaf within 1e-5 of that leaf's largest plus rtol 1e-4."""
    pr = pairs(arch)
    batch = _batch(pr.jcfg)
    (want, want_parts), want_g = pr.grad(pr.jp, _jnp(batch))
    got, parts, got_g = _grads(pr.tm, _port_params(pr.jp), batch)
    assert float(got) == pytest.approx(float(want), rel=2e-5)
    assert float(parts["aux"]) == pytest.approx(float(want_parts["aux"]),
                                                rel=2e-5)
    if pr.jcfg.family == "moe":
        assert float(parts["aux"]) > 0
    paths = jax.tree_util.tree_flatten_with_path(want_g)[0]
    assert len(paths) == len(got_g)
    for (path, a), b in zip(paths, got_g):
        a = np.asarray(a)
        np.testing.assert_allclose(
            b.numpy(), a, rtol=1e-4, atol=1e-5 * np.abs(a).max(),
            err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ARCHES)
def test_train_steps_match_reference(pairs, arch):
    """Three ``train_step``s from the reference's state carried across
    (``train_state_from_numpy``), lr by each package's
    ``cosine_schedule``: losses and grad norms at rtol 1e-4, the params
    as the module docstring says, the step counters."""
    pr = pairs(arch)
    js = pr.ref_state()
    ts = train_state_from_numpy(js, "cpu")
    batch = _batch(pr.jcfg)
    lr_sum = 0.0
    for i in range(3):
        js, jmet = pr.step(js, _jnp(batch))
        ts, tmet = pr.tm.train_step(
            ts, batch, lr_schedule=lambda s: cosine_schedule(s, **SCHED))
        lr_sum += float(jax_cosine(i, **SCHED))
        for k in ("loss", "grad_norm", "ce", "aux"):
            assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-4,
                                                   abs=1e-7), k
        assert int(tmet["step"]) == int(jmet["step"]) == i + 1
        _close_params(jax.tree.leaves(js.params), tree_leaves(ts.params),
                      lr_sum)
    assert int(ts.step) == int(js.step) == 3
    assert all(t.requires_grad for t in tree_leaves(ts.params))


def test_microbatched_step_matches_full_and_reference(pairs):
    """microbatch 2 ≡ the full batch of 8 at rtol 2e-4 (the reference's
    ``test_microbatched_train_step_matches_full``), and ≡ the reference's
    microbatched step: loss and grad norm at rtol 1e-4, params as
    :func:`_close_params`; no ``ce`` / ``aux`` metrics in that mode."""
    full = pairs("qwen3-1.7b")
    mb = pairs("qwen3-1.7b", microbatch=2)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, full.jcfg.vocab, (8, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    sched = lambda s: cosine_schedule(s, **SCHED)
    out = {}
    for name, pr in (("full", full), ("mb", mb)):
        ts = train_state_from_numpy(pr.ref_state(), "cpu")
        for _ in range(2):
            ts, met = pr.tm.train_step(ts, batch, lr_schedule=sched)
        out[name] = (ts, met)
    assert "ce" not in out["mb"][1] and "ce" in out["full"][1]
    assert float(out["mb"][1]["loss"]) == pytest.approx(
        float(out["full"][1]["loss"]), rel=2e-4)
    js = mb.ref_state()
    for _ in range(2):
        js, jmet = mb.step(js, _jnp(batch))
    ts, tmet = out["mb"]
    for k in ("loss", "grad_norm"):
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-4), k
    lr_sum = float(jax_cosine(0, **SCHED)) + float(jax_cosine(1, **SCHED))
    _close_params(jax.tree.leaves(js.params), tree_leaves(ts.params), lr_sum)
    with pytest.raises(ValueError, match="microbatch"):
        mb.tm.train_step(ts, {k: v[:7] for k, v in batch.items()})


def _saved_bytes(model, params, batch):
    """Loss, grads, and the bytes autograd saved for the backward."""
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _, grads = _grads(model, params, batch)
    return loss, grads, saved[0]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b",
                                  "seamless-m4t-large-v2", "hymba-1.5b"])
def test_remat_on_equals_off(arch):
    """Per-layer checkpointing changes no bit of the loss or of any
    gradient (the MoE loss leaves the checkpointed call as an output; the
    encoder is checkpointed too), and saves less for the backward."""
    cfg = get_config(arch).reduced()
    assert cfg.remat
    on = Model(cfg, device="cpu")
    off = Model(dataclasses.replace(cfg, remat=False), device="cpu")
    params = on.init(torch.Generator().manual_seed(0))
    batch = _batch(cfg)
    l_on, g_on, saved_on = _saved_bytes(on, params, batch)
    l_off, g_off, saved_off = _saved_bytes(off, params, batch)
    assert torch.equal(l_on, l_off)
    for a, b in zip(g_on, g_off):
        assert torch.equal(a, b)
    assert saved_on < saved_off, (saved_on, saved_off)


def _converge(arch, steps, seed, **opt):
    cfg = get_config(arch).reduced()
    m = Model(cfg, device="cpu",
              opt_cfg=port_adamw.AdamWConfig(**opt) if opt else None)
    state = m.init_train_state(torch.Generator().manual_seed(0))
    it = make_train_iterator(SyntheticLM(cfg.vocab, 32, seed=seed), 8)
    sched = lambda s: cosine_schedule(s, peak_lr=3e-3, warmup_steps=5,
                                      total_steps=steps)
    losses = []
    for _ in range(steps):
        state, metrics = m.train_step(state, next(it), lr_schedule=sched)
        losses.append(float(metrics["loss"]))
    return losses


def test_training_reduces_loss_dense():
    """The reference's ``test_training_reduces_loss_dense`` on the port."""
    losses = _converge("qwen3-1.7b", 40, 0)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses[::8]


def test_training_reduces_loss_moe():
    """The reference's ``test_training_reduces_loss_moe`` on the port."""
    losses = _converge("olmoe-1b-7b", 50, 1, grad_clip=10.0)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05, losses[::6]


# -- the repairs ------------------------------------------------------------------

def test_repeated_steps_take_fresh_layer_views():
    """Steps 2 and later run (a memoized per-layer view would carry step
    1's freed graph and a version the optimizer's in-place write
    outdated); under grad ``_layers`` makes new views each call and
    memoizes none, without grad it memoizes as serving needs."""
    cfg = get_config("qwen3-1.7b").reduced()
    m = Model(cfg, device="cpu")
    state = m.init_train_state(torch.Generator().manual_seed(0))
    batch = _batch(cfg)
    first = m._layers(state.params)
    assert m._layers(state.params) is not first and not m._views
    losses = []
    for _ in range(4):
        state, met = m.train_step(state, batch)
        losses.append(float(met["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    with torch.no_grad():
        views = m._layers(state.params)
        assert m._layers(state.params) is views
    assert m._layers(state.params) is not views


def test_dropped_params_are_freed_while_the_model_lives():
    """A reduced model serves a step through an engine; once the caller
    drops the engine and its param tree, every stacked leaf is collected
    though the model (and its per-layer view memo) lives on.  The memo
    once held the leaves through the views it kept: after a full-width
    card run's ``del params`` the card still held the weights."""
    import gc
    import weakref
    cfg = get_config("qwen3-1.7b").reduced()
    m = Model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    eng = ServingEngine(m, params, slots=2, max_len=32, chunk=8)
    eng.submit(Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                       max_new_tokens=3))
    while eng.scheduler.pending():
        eng.step()
    with torch.no_grad():
        views = m._layers(eng.params)
        assert m._layers(eng.params) is views and m._views
    refs = [weakref.ref(t) for t in tree_leaves(eng.params["layers"])]
    refs += [weakref.ref(t) for t in tree_leaves(params["layers"])]
    del eng, params, views
    gc.collect()
    assert all(r() is None for r in refs)
    assert not m._views


def _wrapper_calls():
    """One call of each kernel wrapper on CPU tensors, the first input of
    each made to require grad."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.fused_sampler import ops as fs
    from repro_torch.kernels.linked_cbr_pool import ops as cb
    from repro_torch.kernels.linked_matmul import ops as lm
    from repro_torch.kernels.split_matmul import ops as sm
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    kv, pool = [r(2, 5, 2, 8), r(2, 5, 2, 8)], [r(3, 4, 2, 8), r(3, 4, 2, 8)]
    valid = torch.ones(2, 5, dtype=torch.bool)
    tables = torch.tensor([[0, 1], [2, -1]], dtype=torch.int32)
    lens = torch.tensor([6, 3], dtype=torch.int32)
    one, top_k = torch.ones(2), torch.full((2,), 3, dtype=torch.int32)
    cbr, mlp, split = [r(3, 4), r(4)], [r(8, 16), r(8, 16), r(16, 8)], \
        [r(8, 6), r(6)]
    return {
        "gqa_decode": (lambda q: da.gqa_decode(q, *kv, valid), r(2, 4, 8)),
        "gqa_decode_paged": (lambda q: da.gqa_decode_paged(
            q, *pool, tables, lens), r(2, 4, 8)),
        "fused_mask": (lambda x: fs.fused_mask(x, one, top_k, 0.9 * one),
                       r(2, 40)),
        "cbr_avgpool": (lambda x: cb.cbr_avgpool(x, *cbr), r(1, 4, 4, 3)),
        "linked_mlp": (lambda x: lm.linked_mlp(x, *mlp), r(5, 8)),
        "split_matmul": (lambda x: sm.split_matmul(x, *split, block_n=3,
                                                   block_k=4), r(5, 8)),
    }


@pytest.mark.parametrize("kernel", ["gqa_decode", "gqa_decode_paged",
                                    "fused_mask", "cbr_avgpool",
                                    "linked_mlp", "split_matmul"])
def test_wrappers_refuse_inputs_that_require_grad(kernel):
    """A kernel's output carries no gradient, so its wrapper refuses an
    input that requires one under grad mode, on the CPU as on the card;
    under ``no_grad`` (or detached) the same call runs."""
    call, x = _wrapper_calls()[kernel]
    x.requires_grad_(True)
    with pytest.raises(ValueError, match=f"{kernel}: an input requires grad"):
        call(x)
    with torch.no_grad():
        want = call(x)
    assert torch.equal(call(x.detach()), want)


def test_cast_params_detaches_and_serves_a_trained_state():
    """``cast_params`` detaches a train state's leaves (others are
    returned as they are), and an engine serves the trained params to the
    same greedy streams as the same values loaded fresh."""
    cfg = get_config("qwen3-1.7b").reduced()
    m = Model(cfg, device="cpu")
    state = m.init_train_state(torch.Generator().manual_seed(0))
    for _ in range(2):
        state, _ = m.train_step(state, _batch(cfg))
    cast = m.cast_params(state.params)
    assert not any(t.requires_grad for t in tree_leaves(cast))
    plain = jax.tree.map(lambda t: t.detach().clone(), state.params)
    again = m.cast_params(plain)
    assert all(a is b for a, b in zip(tree_leaves(again),
                                      tree_leaves(plain)))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 3)]
    streams = []
    for params in (state.params, plain):
        eng = ServingEngine(m, params, slots=2, max_len=64,
                            replan_every=10_000)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        streams.append([r.generated for r in reqs])
    assert streams[0] == streams[1] and all(streams[0])


def test_loss_fn_under_a_cuda_plan_takes_the_torch_route():
    """Under a plan that routes ``linked_matmul`` to the kernel,
    ``loss_fn`` still runs the torch MLP: its gradients equal the torch
    plan's bit for bit.  ``forward`` under grad with that plan reaches
    the wrapper, which refuses."""
    cfg = get_config("qwen3-1.7b").reduced()
    plain = Model(cfg, device="cpu")
    routed = Model(cfg, device="cpu",
                   kernel_plan=KernelPlan(linked_matmul="cuda"))
    params = plain.init(torch.Generator().manual_seed(0))
    batch = _batch(cfg)
    l0, _, g0 = _grads(plain, params, batch)
    l1, _, g1 = _grads(routed, params, batch)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    grad_params = jax.tree.map(lambda t: t.detach().requires_grad_(True),
                               params)
    with pytest.raises(ValueError, match="linked_mlp"):
        routed.forward(grad_params,
                       {"tokens": torch.from_numpy(batch["tokens"])})
