"""Batched serving example on the PyTorch port: prefill + decode loop with
a KV cache.

    PYTHONPATH=src python examples/serve_lm_torch.py              # the card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

Serves batched synthetic requests from a reduced GQA model: the prompt
runs through the stack token by token into the cache, then greedy
token-by-token decode with the stacked per-layer cache, written in place
(``repro_torch.models.transformer.lm_decode_step``).  The counterpart of
``examples/serve_lm.py``.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.configs import get_bundle
from repro_torch.core.engine.peel_loop import resolve_device
from repro_torch.models import transformer as tf_lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    b = get_bundle("minitron-8b", reduced=True)
    cfg = b.cfg
    params = b.init_params(torch.Generator(dev).manual_seed(0))

    batch, prompt_len, gen_len, max_len = 4, 12, 20, 48
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch, prompt_len), dtype=np.int32)
    ).to(dev)

    cache = tf_lib.init_cache(cfg, batch, max_len, device=dev)
    t0 = time.perf_counter()
    logits = None
    for t in range(prompt_len):
        logits, cache = tf_lib.lm_decode_step(params, cache, prompts[:, t],
                                              cfg)
    out_tokens = []
    tok = torch.argmax(logits, -1).to(torch.int32)
    for _ in range(gen_len):
        out_tokens.append(tok)
        logits, cache = tf_lib.lm_decode_step(params, cache, tok, cfg)
        tok = torch.argmax(logits, -1).to(torch.int32)
    gen = torch.stack(out_tokens, 1).cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"served {batch} requests: {prompt_len} prompt + {gen_len} "
          "generated")
    print(f"first request tokens: {gen[0][:10]}")
    print(f"throughput: {batch * (prompt_len + gen_len) / dt:.0f} tok/s "
          f"({dev}, reduced config)")
    assert cache["len"] == prompt_len + gen_len


if __name__ == "__main__":
    main()
