"""Serving example: batched autoregressive decoding with a KV cache.

Loads a reduced assigned architecture, feeds a batch of synthetic prompts
through the decode step token by token, then decodes new tokens step by
step (ring-buffer cache, one serve step per token) — the long_500k path
in miniature.  The PyTorch port's counterpart of
`examples/serve_decode.py`, a thin wrapper over
`repro_torch.launch.serve.decode`; on the CUDA card (unless `--device cpu`
is given) every attention layer's decode runs through the
`decode_attention` kernel.

    python examples_torch/serve_decode.py --arch mixtral-8x7b
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.launch.serve import decode  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    gen, seconds, _ = decode(args.arch, args.batch, args.prompt_len,
                             args.new_tokens, args.device)
    dt = sum(seconds)
    print(f"arch={args.arch} batch={args.batch} "
          f"decoded {args.new_tokens} tokens in {dt:.2f}s "
          f"({args.batch * args.new_tokens / max(dt, 1e-9):.1f} tok/s)")
    print("first sequence:", gen[0][:16], "...")
    return gen


if __name__ == "__main__":
    main()
