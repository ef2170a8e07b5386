"""The port's encoder-decoder family against the JAX reference.

* **The pieces**, weights carried across through numpy: ``gelu_mlp``
  (tanh GELU, as ``jax.nn.gelu``'s default), ``encoder_stack``,
  ``Model._encode`` and the cross-attention's K/V at 2e-5; the port's
  ``audio_batch_stub`` arrays equal the reference's.
* **The model**: the reference's ``test_prefill_decode_matches_forward``
  replayed on the port for seamless-m4t-large-v2, and the logits of
  ``prefill_step`` (the encoder, then self- and cross-attention, the
  cross K/V written into the caches) and of ``serve_step`` (cross-
  attention over them through the ``decode_dense`` site) against the
  reference's at rtol 3e-4 on reduced seamless-m4t-large-v2.
* **The translate driver**: ``repro_torch.launch.translate_audio`` on
  the reference's weights gives ``examples/translate_audio.py``'s
  greedy stream token for token (B 2, 24 frames, 10 decode steps, seed
  0; the example's steps replayed on the reference's ``Model``); it
  samples through the fused sampler under ``--sample``.
* **Refusals**, by message: ``launch.serve`` on seamless (the
  reference's wording, pointing to the port's driver); the engine's
  refusal of chunked prefill, paged KV and speculation for the family;
  and the model's of chunked prefill, paged caches and verify.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as ref_data
from repro.configs.base import get_config as jax_get_config
from repro.launch import serve as ref_serve
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model import Model as JaxModel
from repro.serving import ServingEngine as JaxEngine
from repro.serving import SpecParams as JaxSpecParams
from repro_torch import data as port_data
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as port_serve
from repro_torch.launch import translate_audio as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model
from repro_torch.serving import ServingEngine
from repro_torch.serving.speculative import SpecParams

RTOL = dict(rtol=3e-4, atol=3e-5)
#: the pieces' tolerance
PIECE = dict(rtol=2e-5, atol=2e-5)
ARCH = "seamless-m4t-large-v2"
_PAIR: dict = {}


def _per_layer_fan_in(jp, cfg):
    """``jp`` with every attention's projections (the encoder's, the
    decoder's self- and cross-attention) at one layer's fan-in, as
    ``tests/test_torch_recurrent.py`` draws hymba's: the reference's init
    takes a stacked 4-D leaf's fan-in from its layer axis (2 at reduced
    depth), so reduced seamless attends with near-one-hot softmaxes
    (:func:`test_reduced_seamless_at_the_raw_init_is_ill_conditioned`)."""
    def scaled(attn, L):
        out = dict(attn)
        for k in ("wq", "wk", "wv"):
            out[k] = attn[k] * np.sqrt(L / cfg.d_model)
        out["wo"] = attn["wo"] * np.sqrt(
            L / (cfg.n_heads * cfg.resolved_head_dim))
        return out
    layers = dict(jp["layers"])
    for k in ("attn", "cross_attn"):
        layers[k] = scaled(layers[k], cfg.n_layers)
    enc = dict(jp["encoder"], attn=scaled(jp["encoder"]["attn"],
                                          cfg.encoder_layers))
    return {**jp, "layers": layers, "encoder": enc}


def _pair(raw=False):
    """(reference model, reference params, port model, port params) of
    reduced seamless-m4t-large-v2; its attention at the per-layer fan-in
    unless ``raw``."""
    if raw not in _PAIR:
        jcfg = jax_get_config(ARCH).reduced()
        jm = JaxModel(jcfg)
        jp = jm.init(jax.random.key(0))
        if not raw:
            jp = _per_layer_fan_in(jp, jcfg)
        tm = Model(ModelConfig(**dataclasses.asdict(jcfg)), device="cpu")
        _PAIR[raw] = (jm, jp, tm, params_from_numpy(
            jax.tree.map(np.asarray, jp), "cpu"))
    return _PAIR[raw]


def _frames(cfg, B=2, S=10, seed=0):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def test_gelu_mlp_and_encoder_pieces_match_reference():
    """``gelu_mlp``, ``encoder_stack``, ``_encode`` and the cross K/V."""
    jm, jp, tm, tp = _pair()
    x = _frames(jm.cfg)
    lj = jax.tree.map(lambda a: a[0], jp["encoder"])
    lt = TT.layer_views(tp["encoder"], jm.cfg.encoder_layers)
    np.testing.assert_allclose(
        TL.gelu_mlp(lt[0]["mlp"], torch.from_numpy(x)).numpy(),
        np.asarray(JL.gelu_mlp(lj["mlp"], jnp.asarray(x))), **PIECE)
    np.testing.assert_allclose(
        TT.encoder_stack(lt, torch.from_numpy(x), cfg=tm.cfg).numpy(),
        np.asarray(JT.encoder_stack(jp["encoder"], jnp.asarray(x),
                                    cfg=jm.cfg)), **PIECE)
    ej = jm._encode(jp, jnp.asarray(x))
    et = tm._encode(tp, torch.from_numpy(x))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), **PIECE)
    cj = JT._cross_kv(jax.tree.map(lambda a: a[1],
                                   jp["layers"]["cross_attn"]), ej)
    ct = TT.cross_kv(tm._layers(tp)[1]["cross_attn"], et)
    for a, b in zip(ct, cj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **PIECE)


def test_reduced_seamless_at_the_raw_init_is_ill_conditioned():
    """At the reference's own init the reduced encoder's output moves past
    the pieces' 2e-5 when the reference's weights move by 1e-7
    (relative); the port stays within that move, and under 5% of the
    outputs leave the bound.  The parity tests above draw the attention
    at the per-layer fan-in."""
    jm, jp, tm, tp = _pair(raw=True)
    x = _frames(jm.cfg)
    ref = np.asarray(jm._encode(jp, jnp.asarray(x)))
    moved = np.asarray(jm._encode(
        jax.tree.map(lambda a: a * (1 + 1e-7), jp), jnp.asarray(x)))
    port = tm._encode(tp, torch.from_numpy(x)).numpy()
    bound = PIECE["atol"] + PIECE["rtol"] * np.abs(ref)
    assert (np.abs(moved - ref) > bound).any()
    assert np.abs(port - ref).max() <= np.abs(moved - ref).max()
    assert (np.abs(port - ref) > bound).mean() < 0.05


@pytest.mark.parametrize("seed", [0, 1])
def test_audio_batch_stub_matches_reference(seed):
    a = port_data.audio_batch_stub(2, 24, 4, 256, 512, seed=seed)
    b = ref_data.audio_batch_stub(2, 24, 4, 256, 512, seed=seed)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def test_prefill_decode_matches_forward_on_the_port():
    """``tests/test_arch_smoke.py::test_prefill_decode_matches_forward``
    for seamless-m4t-large-v2, on the port (its tolerances)."""
    cfg = ModelConfig(**dataclasses.asdict(jax_get_config(ARCH).reduced()))
    m = Model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    B, S = 2, 16
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                            .astype(np.int32))
    src = torch.from_numpy(rng.normal(size=(B, S, cfg.d_model))
                           .astype(np.float32))
    full, _ = m.forward(params, {"tokens": toks, "src": src})
    lg, caches = m.prefill_step(params, {"tokens": toks[:, :S // 2],
                                         "src": src}, max_len=S)
    np.testing.assert_allclose(lg.numpy(), full[:, S // 2 - 1].numpy(),
                               rtol=1e-3, atol=1e-4)
    for t in range(S // 2, S):
        lg, caches = m.serve_step(params, caches, toks[:, t:t + 1])
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   rtol=1e-3, atol=1e-4)


def test_prefill_and_decode_logits_match_reference():
    """The encoder-decoder prefill and five decode steps; the cross K/V
    cached in the compute dtype equal the reference's."""
    jm, jp, tm, tp = _pair()
    rng = np.random.default_rng(3)
    src = _frames(jm.cfg, B=3, S=14, seed=3)
    toks = rng.integers(0, jm.cfg.vocab, (3, 5)).astype(np.int32)
    lj, cj = jm.prefill_step(jp, {"src": jnp.asarray(src),
                                  "tokens": jnp.asarray(toks)}, max_len=16)
    lt, ct = tm.prefill_step(tp, {"src": torch.from_numpy(src),
                                  "tokens": torch.from_numpy(toks)},
                             max_len=16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **RTOL)
    assert tuple(ct.cross_k.shape) == cj.cross_k.shape == (
        jm.cfg.n_layers, 3, 14, jm.cfg.n_kv_heads, jm.cfg.resolved_head_dim)
    np.testing.assert_allclose(ct.cross_v.numpy(), np.asarray(cj.cross_v),
                               **PIECE)
    step = jax.jit(lambda p, c, t: jm.serve_step(p, c, t))
    for _ in range(5):
        nt = rng.integers(0, jm.cfg.vocab, (3, 1)).astype(np.int32)
        lj, cj = step(jp, cj, jnp.asarray(nt))
        lt, ct = tm.serve_step(tp, ct, torch.from_numpy(nt))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **RTOL)


def _example_stream(jm, jp, B=2, src_len=24, steps=10, seed=0):
    """``examples/translate_audio.py``'s greedy stream on ``jm``/``jp``:
    its steps, as the example takes them."""
    cfg = jm.cfg
    stub = ref_data.audio_batch_stub(B, src_len, 4, cfg.d_model, cfg.vocab,
                                     seed=seed)
    batch = {"src": jnp.asarray(stub["src"]),
             "tokens": jnp.asarray(stub["tokens"][:, :4])}
    logits, caches = jm.prefill_step(jp, batch, max_len=32)
    tok = jnp.argmax(logits[:, :cfg.vocab], -1)[:, None].astype(jnp.int32)
    hyps = [tok]
    step = jax.jit(lambda p, c, t: jm.serve_step(p, c, t))
    for _ in range(steps):
        logits, caches = step(jp, caches, tok)
        tok = jnp.argmax(logits[:, :cfg.vocab], -1)[:, None].astype(
            jnp.int32)
        hyps.append(tok)
    return np.asarray(jnp.concatenate(hyps, axis=1))


def test_translate_driver_matches_reference_example():
    """The port's driver on the reference's weights (its raw init, as the
    example draws them): the example's greedy stream, token for token;
    sampled, every token in the vocabulary and the same tokens from a
    second run."""
    jm, jp, tm, tp = _pair(raw=True)
    args = TA.build_parser().parse_args(["--reduced", "--device", "cpu"])
    assert (args.batch, args.src_len, args.new_tokens, args.seed) == \
        (2, 24, 10, 0)
    model = TA.build_model(args)
    src, prompt = TA.stub_inputs(model, args.batch, args.src_len, args.seed)
    got, _ = TA.translate(model, tp, src, prompt,
                          new_tokens=args.new_tokens)
    np.testing.assert_array_equal(got.numpy(), _example_stream(jm, jp))
    sampling = TA.parse_sample("0.8,50,0.95", seed=3)
    runs = [TA.translate(model, tp, src, prompt, new_tokens=6,
                         sampling=sampling)[0] for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert ((runs[0] >= 0) & (runs[0] < model.cfg.vocab)).all()


def test_translate_command_runs(capsys):
    assert TA.main(["--reduced", "--device", "cpu", "--new-tokens", "3",
                    "--sample", "0.8,50,0.95"]) == 0
    assert "translate_audio OK" in capsys.readouterr().out


def test_serve_refuses_encoder_decoder_like_reference():
    """The reference's wording, pointing to the port's driver."""
    msgs = []
    for mod, argv in ((ref_serve, ["--arch", ARCH, "--reduced"]),
                      (port_serve, ["--arch", ARCH, "--reduced", "--device",
                                    "cpu"])):
        with pytest.raises(SystemExit) as e:
            mod.main(argv)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0].replace(
        "examples/translate_audio.py",
        "src/repro_torch/launch/translate_audio.py")


@pytest.mark.parametrize("kw", [
    dict(prefill_mode="chunked"), dict(kv="paged"),
    dict(spec="ngram")], ids=["chunked", "paged", "spec"])
def test_engine_refusals_match_reference(kw):
    """The engine refuses chunked prefill, paged KV and speculation for
    the encoder-decoder family, with the reference's messages."""
    jm, jp, tm, tp = _pair()
    msgs = []
    for engine, model, params, spec in ((JaxEngine, jm, jp, JaxSpecParams),
                                        (ServingEngine, tm, tp, SpecParams)):
        opts = dict(kw)
        if "spec" in opts:
            opts["spec"] = spec(mode="ngram", k=2)
        with pytest.raises(ValueError) as e:
            engine(model, params, slots=2, max_len=32, **opts)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_model_refusals_match_reference():
    """Chunked prefill, paged caches and verify: the reference's refusals
    (its ``cache_family`` rules) by message."""
    jm, jp, tm, tp = _pair()
    calls = (
        lambda m, p, arr: m.prefill_chunk(
            p, m.init_caches(2, 16), arr(np.zeros((2, 4), np.int32)),
            arr(np.zeros(2, np.int32)), arr(np.ones(2, np.int32))),
        lambda m, p, arr: m.init_paged_caches(2, pool_blocks=4, block_size=8,
                                              max_blocks=2),
        lambda m, p, arr: m.verify_step(
            p, m.init_caches(2, 16), arr(np.zeros((2, 2), np.int32)),
            arr(np.ones(2, np.int32))))
    for call in calls:
        msgs = []
        for m, p, arr in ((jm, jp, jnp.asarray), (tm, tp, torch.from_numpy)):
            with pytest.raises(NotImplementedError) as e:
                call(m, p, arr)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
