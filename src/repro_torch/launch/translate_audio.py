"""Encoder-decoder driver of the port: stub audio frames -> text tokens.

    PYTHONPATH=src python -m repro_torch.launch.translate_audio --reduced \
        --device cpu

    PYTHONPATH=src python -m repro_torch.launch.translate_audio \
        --batch 8 --src-len 512 --new-tokens 64 --sample 0.8,50,0.95

The counterpart of ``examples/translate_audio.py`` for
seamless-m4t-large-v2 (``--reduced``: its CPU smoke variant).  The
audio frontend is the stub carve-out (``repro_torch.data.
audio_batch_stub``: precomputed frame embeddings from ``--seed``).  The
decoder prefills a 4-token target prompt over the encoder's output
(``Model.prefill_step``: the encoder, then self- and cross-attention,
the cross K/V written into the caches), takes its first token, then
decodes ``--new-tokens`` steps (``Model.serve_step``: self-attention over
the growing cache and cross-attention over the static encoder K/V, both
through the ``decode_dense`` site, the ``gqa_decode`` kernel on the
card).  Greedy by default; ``--sample T,k,p`` samples each token through
the fused sampler (``fused_mask`` on the card), keyed by the utterance's
seed (``--seed`` + its index) and the tokens it has emitted, as the
serving engine keys a request.  Weights are random, drawn on the device
from ``--seed``.  The serving engine drives decoder-only stacks, so
``repro_torch.launch.serve`` refuses this family and points here.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..configs.base import get_config
from ..core.pipeline import select_kernel_plan
from ..data import audio_batch_stub
from ..kernels.fused_sampler import ops as fused_ops
from ..models.model import Model
from ..serving import SamplingParams

ARCH = "seamless-m4t-large-v2"
#: the target prompt's tokens, as the reference example's
PROMPT_LEN = 4


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--src-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=10,
                    help="decode steps after the prefill's token")
    ap.add_argument("--sample", default=None,
                    help="T,k,p: sample at temperature T, top-k k, top-p p "
                         "(default: greedy)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def parse_sample(text: str | None, seed: int = 0) -> SamplingParams | None:
    """``--sample T,k,p`` at ``seed`` (None: greedy)."""
    if text is None:
        return None
    t, k, p = text.split(",")
    return SamplingParams(temperature=float(t), top_k=int(k), top_p=float(p),
                          seed=seed)


def translate(model, params, src, prompt, *, new_tokens: int,
              sampling: SamplingParams | None = None, on_step=None):
    """Tokens (B, 1 + new_tokens) int32 for frames src (B, Ssrc, d) and
    target prompts (B, P): the prefill's token, then one a decode step.
    Greedy unless ``sampling`` samples: utterance b then draws with key
    ``fold_in(key(sampling.seed + b), i)`` for its i-th token.
    ``on_step(i, logits)`` runs after the prefill (i = 0) and each decode
    step, with the logits token i was picked from."""
    dev = model.device
    B = prompt.shape[0]
    logits, caches = model.prefill_step(
        params, {"src": src, "tokens": prompt},
        max_len=prompt.shape[1] + new_tokens + 1)
    vocab = model.cfg.vocab
    backend = "cuda" if model.kernel_plan.sampler == "cuda" else "torch"
    if sampling is not None and not sampling.greedy:
        seeds = torch.arange(sampling.seed, sampling.seed + B, device=dev)
        policy = (torch.full((B,), sampling.temperature, device=dev),
                  torch.full((B,), sampling.top_k, dtype=torch.int32,
                             device=dev),
                  torch.full((B,), sampling.top_p, device=dev))

    def pick(logits, i):
        if sampling is None or sampling.greedy:
            return torch.argmax(logits[:, :vocab], dim=-1).to(torch.int32)
        steps = torch.full((B,), i, dtype=torch.int64, device=dev)
        return fused_ops.fused_sample(logits, seeds, steps, *policy,
                                      vocab=vocab, backend=backend)
    out = [pick(logits, 0)]
    if on_step is not None:
        on_step(0, logits)
    for i in range(new_tokens):
        logits, caches = model.serve_step(params, caches, out[-1][:, None])
        out.append(pick(logits, i + 1))
        if on_step is not None:
            on_step(i + 1, logits)
    return torch.stack(out, dim=1), caches


def build_model(args) -> Model:
    """The arch (reduced with ``--reduced``) on ``--device`` under the
    device's kernel plan (the card's routes attention and the sampler to
    the CUDA kernels)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.is_encoder_decoder:
        raise SystemExit(f"translate_audio drives encoder-decoder archs; "
                         f"{cfg.name} is decoder-only (see launch.serve)")
    plan, _ = select_kernel_plan({"accelerator": args.device})
    return Model(cfg, kernel_plan=plan, device=args.device)


def stub_inputs(model, batch: int, src_len: int, seed: int):
    """The stub frames and the target prompts, on the model's device."""
    cfg = model.cfg
    stub = audio_batch_stub(batch, src_len, PROMPT_LEN, cfg.d_model,
                            cfg.vocab, seed=seed)
    return (torch.from_numpy(stub["src"]).to(model.device),
            torch.from_numpy(stub["tokens"][:, :PROMPT_LEN]).to(model.device))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    model = build_model(args)
    cfg = model.cfg
    params = model.cast_params(model.init(
        torch.Generator(device=model.device).manual_seed(args.seed)))
    print(f"arch={cfg.name} enc_layers={cfg.encoder_layers} "
          f"dec_layers={cfg.n_layers} params={model.param_count():,} on "
          f"{model.device}")
    src, prompt = stub_inputs(model, args.batch, args.src_len, args.seed)
    sampling = parse_sample(args.sample, args.seed)
    times = []

    def tick(i, logits):
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)
        times.append(time.perf_counter())
    t0 = time.perf_counter()
    toks, _ = translate(model, params, src, prompt,
                        new_tokens=args.new_tokens, sampling=sampling,
                        on_step=tick)
    toks = toks.cpu().numpy()
    for b in range(args.batch):
        print(f"utterance {b}: src_frames={args.src_len} -> tokens {toks[b]}")
    steps = np.diff(times) * 1e3
    print(f"encode + prefill {(times[0] - t0) * 1e3:.1f} ms; decode step "
          f"{steps.mean() if len(steps) else 0.0:.2f} ms over {len(steps)} "
          f"steps; {sampling or 'greedy'}")
    if not ((toks >= 0) & (toks < cfg.vocab)).all():
        print("FAIL: a token outside the vocabulary", file=sys.stderr)
        return 1
    print("translate_audio OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
