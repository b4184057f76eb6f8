"""Serving entry point of the LM (every decoding family: dense, MoE, SSM,
hybrid and VLM): batched prefill, then greedy decode.

Counterpart of ``src/repro/launch/serve.py``.  ``init`` (random weights from
``seed``, or ``params``), one ``prefill`` over the prompt batch, then
``decode_step`` lock-step for ``gen_tokens - 1`` more tokens.  Prompts are
drawn as the JAX package draws them, so both packages serve the same
prompts.  On the card every prefill attention layer (GQA or MLA) runs the
hand-written flash kernel.  After an SSM block the prefill leaves a fresh
state, as the reference's does; an encoder (HuBERT) raises.

With ``mesh`` (a ``DeviceMesh`` of ``pod`` x ``data`` x ``model`` ranks;
every rank calls :func:`serve`) each rank prefills and decodes its block of
the prompt batch's rows, the reference's batch sharding under ``with
mesh:``; a MoE plans its tokens as its share of the reference's plan over
every rank's (:mod:`repro_torch.models.moe`).  The parameters are
replicated over the batch axes, as the reference's serve leaves them, and
cut over a ``model`` axis larger than 1 (tensor parallelism,
:mod:`repro_torch.runtime.tensor_parallel`: a rank holds about 1/k of
them, and its decode cache holds its KV heads); the vocabulary-parallel
logits are gathered over that axis where a token is picked.  The generated
tokens are gathered, so every rank returns the whole batch's.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --reduced \\
        --device cpu --batch 4 --prompt-len 32 --gen 32
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve --arch qwen2-1.5b \
        --reduced --device cpu --model-parallel 2                     # 2 gloo ranks, TP
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b   # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \
        --batch 4 --prompt-len 2048                                    # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \
        --batch 4 --prompt-len 2048                                    # on the card
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import configs
from ..models.model import Transformer
from ..runtime.data_parallel import DataParallelPlan, mesh_device
from . import mesh as mesh_mod


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
    mesh=None,
) -> Dict:
    """Serve one batch of random prompts; ``params`` (a state dict, e.g. from
    :func:`repro_torch.convert.lm_params_from_reference`) replaces the random
    weights.  Returns the generated tokens (batch, gen_tokens), the prefill's
    last-token logits of this rank's rows (rows, vocab; the whole batch's on
    one device), timings (this rank's) and the bytes of the weights this
    rank holds (``at_rest_bytes``, the plan's count)."""
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only; no decode path")
    dev = mesh_device(mesh, device, cfg)
    S_max = prompt_len + gen_tokens
    rng = np.random.default_rng(seed)
    if params is None:
        model = Transformer(cfg, device=dev, seed=seed)
    else:
        model = Transformer.from_params(cfg, params, device=dev)
    plan = DataParallelPlan(cfg, model, mesh)
    plan.gather_params(model, plan.shard_params(model))  # this rank's blocks, kept
    lo, rows = plan.rows(batch)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len))[lo:lo + rows],
                              dtype=torch.long, device=dev)
    sampler = None if greedy else torch.Generator(device=dev).manual_seed(seed)

    with plan.scope():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(prompts, S_max)
        first = plan.gather_vocab(logits[:, -1, :])
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        tok = torch.argmax(first, dim=-1)
        out_tokens = [tok]
        t0 = time.perf_counter()
        for i in range(gen_tokens - 1):
            pos = torch.full((rows,), prompt_len + i, dtype=torch.long, device=dev)
            logits, cache = model.decode_step(cache, tok, pos)
            logits = plan.gather_vocab(logits[:, 0, :])
            if greedy:
                tok = torch.argmax(logits, dim=-1)
            else:  # not the JAX package's bits: its sampler draws from jax.random
                probs = torch.softmax(logits.float(), dim=-1)
                tok = torch.multinomial(probs, 1, generator=sampler)[:, 0]
            out_tokens.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t0

    generated = plan.gather_rows(torch.stack(out_tokens, dim=1)).cpu().numpy()
    return {
        "generated": generated,
        "prefill_logits": first,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tokens_per_s": batch * (gen_tokens - 1) / max(t_decode, 1e-9),
        "at_rest_bytes": plan.at_rest_bytes(),
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
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks of the mesh's model axis under a launcher")
    args = ap.parse_args()
    cfg = configs.get_reduced(args.arch) if args.reduced else configs.get_config(args.arch)
    out = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen_tokens=args.gen,
                seed=args.seed, device=args.device,
                mesh=mesh_mod.launcher_mesh(device=args.device,
                                            model_parallel=args.model_parallel))
    print(f"prefill {out['prefill_s']:.2f}s; decode {out['decode_s']:.2f}s; "
          f"{out['tokens_per_s']:.1f} tok/s")
    print("sample:", out["generated"][0][:16])


if __name__ == "__main__":
    main()
