"""Batched autoregressive decoding with the ring KV cache, from the command
line: the port's counterpart of the JAX package's `examples/serve_decode.py`.

Builds an assigned architecture of any family at its reduced preset,
feeds a batch of synthetic prompts through the decode step token by token,
then decodes new tokens greedily (argmax), one `build_serve_step` call
per token; every self-attention layer runs through the `decode_attention`
kernel on the card (the SSM keeps a recurrent state instead).  For the
enc-dec family (whisper) it first draws encoder frames from numpy,
N(0, 1) · 0.05 of shape [batch, max_len // enc_seq_divisor, D] as the
reference's example does, and fills the cross-attention cache with
`prep_decode_cache`.  Runs on the CUDA card unless `--device cpu` is
given.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.dist.dfl_step import build_serve_step
from repro_torch.models.lm import build_lm


def generate(step, params, cache, prompts: torch.Tensor, decode_steps: int):
    """Feed `prompts` [B, P] through `step` one token at a time, then take
    the first new token from the last prompt logits and decode
    `decode_steps` more greedily.  Returns (tokens [B, decode_steps + 1],
    the last logits, the cache, the wall seconds of each decode step, each
    ended by a synchronize on the card)."""
    sync = torch.cuda.synchronize if prompts.is_cuda else (lambda: None)
    logits = None
    for t in range(prompts.shape[1]):
        logits, cache = step(params, cache, prompts[:, t:t + 1])
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out, seconds = [tok], []
    sync()
    for _ in range(decode_steps):
        t0 = time.perf_counter()
        logits, cache = step(params, cache, tok)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        sync()
        seconds.append(time.perf_counter() - t0)
        out.append(tok)
    return torch.cat(out, dim=1), logits, cache, seconds


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    lm = build_lm(cfg)
    dev = resolve_device(args.device)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.batch, args.prompt_len))).to(dev)

    max_len = args.prompt_len + args.new_tokens
    cache = lm.init_cache(args.batch, max_len, device=dev)
    if lm.prep_decode_cache is not None:  # enc-dec: run the encoder once
        enc = torch.from_numpy(rng.standard_normal(
            (args.batch, max_len // cfg.enc_seq_divisor, cfg.d_model))
            * 0.05).to(dev).to(cfg.adtype)
        with torch.inference_mode():
            cache = lm.prep_decode_cache(params, cache, enc)
    tokens, logits, cache, seconds = generate(
        build_serve_step(lm), params, cache, prompts, args.new_tokens - 1)
    dt = sum(seconds)
    rate = f"{args.batch * len(seconds) / dt:.1f}" if dt > 0 else "n/a"
    print(f"arch={args.arch} batch={args.batch} "
          f"device={dev} decoded {args.new_tokens} tokens "
          f"({len(seconds)} decode steps) in {dt:.2f}s ({rate} tok/s)")
    gen = tokens.cpu().numpy()
    print("first sequence:", gen[0][:16], "...")
    assert bool(torch.isfinite(logits.float()).all()), "non-finite logits"
    return gen


if __name__ == "__main__":
    main()
