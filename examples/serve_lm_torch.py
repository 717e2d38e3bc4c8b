"""Serve an LM with batched requests on the port: prefill + sampled decode.

The PyTorch twin of ``examples/serve_lm.py``. On the card (the default)
the prefill and each decode step replay CUDA graphs captured on the first
batch; with ``--device cpu`` both run eagerly. By default the model is the
qwen1.5-0.5b *reduced* config; ``--arch`` picks any of the ten configs
(dense, moe, audio, vlm, hybrid, ssm; vlm gets image embeddings drawn from
``--seed``), ``--full`` serves it at its published width and depth (for
qwen1.5-0.5b 24 layers, d 1024, vocab 151936, bf16), with random weights
from ``--seed``.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--batch 4 --new 24]
      PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
      PYTHONPATH=src python examples/serve_lm_torch.py --device cpu \
          --arch zamba2-7b
      PYTHONPATH=src python examples/serve_lm_torch.py --full
      PYTHONPATH=src python examples/serve_lm_torch.py --full \
          --arch rwkv6-3b
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.launch.serve import generate
from repro_torch.models import lm
from repro_torch.models.backend import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--full", action="store_true",
                    help="the published width and depth, not reduced()")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        # bf16 GEMMs accumulate in float32, as the reference's XLA does
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    cfg = get_config(args.arch)
    cfg = cfg if args.full else cfg.reduced()
    params = lm.init(args.seed, cfg, device=device)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32))
    image = None
    if cfg.family == "vlm":
        image = torch.from_numpy(rng.normal(size=(
            args.batch, cfg.n_image_tokens, cfg.d_image)).astype(np.float32)
        ).to(device=device, dtype=cfg.jdtype)
    out, stats = generate(params, cfg, prompts, max_new_tokens=args.new,
                          temperature=args.temperature, key=args.seed,
                          image_embeds=image, verbose=True, device=device)
    print(f"{cfg.name} on {device}: prefill {stats['prefill_s']*1e3:.1f} ms"
          f"   decode: {stats['decode_tok_per_s']:.1f} tok/s "
          f"(batch {args.batch})")
    print("generated token ids (first request):",
          out[0, args.prompt_len:].tolist())
    return out, stats


if __name__ == "__main__":
    main(sys.argv[1:])
