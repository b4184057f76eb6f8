"""Serving entry point of the dense LM: batched prefill, then greedy decode.

Counterpart of ``src/repro/launch/serve.py``.  ``init`` (random weights from
``seed``, or ``params``), one ``prefill`` over the prompt batch, then
``decode_step`` lock-step for ``gen_tokens - 1`` more tokens.  Prompts are
drawn as the JAX package draws them, so both packages serve the same
prompts.  On the card every prefill attention layer runs the hand-written
flash kernel.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --reduced \\
        --device cpu --batch 4 --prompt-len 32 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b   # on the card
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import _device, configs
from ..models.model import Transformer


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve(
    cfg,
    *,
    batch: int = 4,
    prompt_len: int = 32,
    gen_tokens: int = 32,
    seed: int = 0,
    greedy: bool = True,
    device=None,
    params: Optional[Dict] = None,
) -> Dict:
    """Serve one batch of random prompts; ``params`` (a state dict, e.g. from
    :func:`repro_torch.convert.lm_params_from_reference`) replaces the random
    weights.  Returns the generated tokens (batch, gen_tokens) and timings."""
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only; no decode path")
    dev = _device.resolve(device)
    S_max = prompt_len + gen_tokens
    rng = np.random.default_rng(seed)
    if params is None:
        model = Transformer(cfg, device=dev, seed=seed)
    else:
        model = Transformer.from_params(cfg, params, device=dev)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
                              dtype=torch.long, device=dev)
    sampler = None if greedy else torch.Generator(device=dev).manual_seed(seed)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts, S_max)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(logits[:, -1, :], dim=-1)
    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(gen_tokens - 1):
        pos = torch.full((batch,), prompt_len + i, dtype=torch.long, device=dev)
        logits, cache = model.decode_step(cache, tok, pos)
        if greedy:
            tok = torch.argmax(logits[:, 0, :], dim=-1)
        else:  # not the JAX package's bits: its sampler draws from jax.random
            probs = torch.softmax(logits[:, 0, :].float(), dim=-1)
            tok = torch.multinomial(probs, 1, generator=sampler)[:, 0]
        out_tokens.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    generated = torch.stack(out_tokens, dim=1).cpu().numpy()
    return {
        "generated": generated,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tokens_per_s": batch * (gen_tokens - 1) / max(t_decode, 1e-9),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    cfg = configs.get_reduced(args.arch) if args.reduced else configs.get_config(args.arch)
    out = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen_tokens=args.gen,
                seed=args.seed, device=args.device)
    print(f"prefill {out['prefill_s']:.2f}s; decode {out['decode_s']:.2f}s; "
          f"{out['tokens_per_s']:.1f} tok/s")
    print("sample:", out["generated"][0][:16])


if __name__ == "__main__":
    main()
