"""LM decode serving driver: ``python -m repro_torch.launch.serve_lm``
(port of ``repro.launch.serve_lm``).

Batched request loop over the decode step: synthetic requests in a fixed
slot count with per-slot prompt/generation state, one decode step per
token across the whole batch.  The KV cache is preallocated once on the
device and written in place; its length is a host int, so a step reads
nothing back from the card, and the generated tokens come to the host
once, at the end of ``run``.

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_bundle
from ..core.engine.peel_loop import resolve_device
from ..models import transformer as tf_lib


class BatchedServer:
    """Continuous-batching decode server over a fixed slot count.

    Params are drawn from a generator seeded 0 on ``device`` (None: the
    card), or taken as given (``params``: an ``LM`` module, which sets
    the device)."""

    def __init__(self, bundle, batch_slots: int = 4, max_len: int = 64, *,
                 params=None, device=None):
        self.cfg = bundle.cfg
        if params is None:
            dev = resolve_device(device)
            params = bundle.init_params(torch.Generator(dev).manual_seed(0))
        self.params = params
        self.device = params.embed.device
        self.slots = batch_slots
        self.max_len = max_len
        self.cache = tf_lib.init_cache(self.cfg, batch_slots, max_len,
                                       device=self.device)

    def _decode(self, token: torch.Tensor) -> torch.Tensor:
        logits, self.cache = tf_lib.lm_decode_step(
            self.params, self.cache, token, self.cfg)
        return logits

    def run(self, prompts: np.ndarray, gen_len: int) -> np.ndarray:
        """prompts: (slots, prompt_len) int32.  Returns (slots, gen_len)."""
        n, plen = prompts.shape
        assert n == self.slots
        if self.cache["len"] + plen + gen_len > self.max_len:
            raise ValueError(
                f"{plen} + {gen_len} tokens after {self.cache['len']} do not "
                f"fit the {self.max_len}-token cache")
        prompt = torch.as_tensor(np.asarray(prompts, np.int32)).to(
            self.device)
        logits = None
        for t in range(plen):
            logits = self._decode(prompt[:, t])
        outs = []
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        for _ in range(gen_len):
            outs.append(tok)
            logits = self._decode(tok)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return torch.stack(outs, dim=1).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-8b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    bundle = get_bundle(args.arch, reduced=True)
    server = BatchedServer(bundle, batch_slots=args.slots,
                           max_len=args.prompt_len + args.gen_len + 4,
                           device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(
        0, bundle.cfg.vocab, (args.slots, args.prompt_len), dtype=np.int32
    )
    t0 = time.perf_counter()
    out = server.run(prompts, args.gen_len)
    dt = time.perf_counter() - t0
    print(f"[serve] {args.slots} slots x ({args.prompt_len}+{args.gen_len}) "
          f"tokens in {dt:.1f}s "
          f"({args.slots*(args.prompt_len+args.gen_len)/dt:.0f} tok/s) on "
          f"{server.device}")
    print(f"[serve] sample output: {out[0][:12]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
