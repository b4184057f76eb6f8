"""AdamW with LR schedules, clipping and 8-bit block-quantized moments.

Counterpart of ``src/repro/optim/adamw.py``, in plain tensor ops (not
``torch.optim.AdamW``, whose update is another formula).  Parameters,
gradients and moments are dicts keyed by parameter name (the port's
``Transformer.named_parameters()``), where the JAX package maps over
pytrees.  The arithmetic is the reference's, op for op: global-norm
clipping, bias correction, decoupled weight decay, and bf16 parameters
updated in fp32 and cast back with no master copy.  Unlike the reference,
which returns new arrays, :meth:`AdamW.update` writes the new parameters and
fp32 moments in place (one parameter at a time), so a step holds no second
copy of either.

The schedule and bias-correction scalars are computed in fp32 on the host
from the step count (a Python int), so a step reads nothing back from the
card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> float:
    """Linear warm-up to ``peak_lr``, then cosine decay to ``final_frac *
    peak_lr`` at ``total_steps``; computed in fp32 as the reference does."""
    f32 = torch.float32
    step = torch.tensor(float(step), dtype=f32)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_frac + (1.0 - final_frac) * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return float(torch.where(step < warmup_steps, warm, peak_lr * cos))


# ---------------------------------------------------------------------------
# 8-bit block quantization (per-block absmax scaling)
# ---------------------------------------------------------------------------

_QBLOCK = 256

Quantized = Tuple[torch.Tensor, torch.Tensor]  # (int8 (nblocks, 256), fp32 scale (nblocks, 1))


def _quantize(x: torch.Tensor) -> Quantized:
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % _QBLOCK))
    blocks = flat.reshape(-1, _QBLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale.float()


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
                dtype=torch.float32) -> torch.Tensor:
    n = math.prod(shape)
    return (q.float() * scale).reshape(-1)[:n].reshape(shape).to(dtype)


class AdamWState(NamedTuple):
    step: Any  # updates taken (an int; a 0-d array or tensor after a restore)
    mu: Dict[str, Any]  # first moment: fp32 tensors, or (int8, scale) pairs
    nu: Dict[str, Any]  # second moment (quantized: sqrt(nu))


@dataclasses.dataclass(frozen=True)
class AdamW:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    quantize_states: bool = False  # 8-bit moments (beyond-paper)

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        def zeros(p):
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            return _quantize(z) if self.quantize_states else z

        return AdamWState(step=0, mu={k: zeros(p) for k, p in params.items()},
                          nu={k: zeros(p) for k, p in params.items()})

    def _lr(self, step: int) -> float:
        return warmup_cosine(step, peak_lr=self.peak_lr, warmup_steps=self.warmup_steps,
                             total_steps=self.total_steps)

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: AdamWState, *, sq_norm: Optional[torch.Tensor] = None,
               block: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
               ) -> Tuple[Dict[str, torch.Tensor], AdamWState]:
        """One step.  Writes the new values into ``params`` (and the fp32
        moments) in place and returns ``(params, new_state)``.  ``params``
        and ``grads`` may be whole leaves or a rank's blocks of them: then
        ``sq_norm``, the sum of every squared gradient entry of the whole
        model (``runtime.data_parallel.DataParallelPlan.sq_norm``), sets the
        clip scale; by default it is summed from ``grads``.  The moments
        have the gradients' shapes; with ``block``, a gradient (and its
        moments) is the whole leaf while the parameter is a rank's block,
        and ``block(name, update)`` cuts the whole update to it (8-bit
        moments on a model axis)."""
        step = int(state.step) + 1
        lr = self._lr(step)
        scale = None
        if self.clip_norm is not None:
            if sq_norm is None:
                sq_norm = torch.sum(torch.stack(
                    [torch.sum(torch.square(g.float())) for g in grads.values()]))
            gn = torch.sqrt(sq_norm)
            scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
        f32 = torch.float32
        t = torch.tensor(float(step), dtype=f32)
        bc1 = float(1.0 - torch.pow(torch.tensor(self.b1, dtype=f32), t))
        bc2 = float(1.0 - torch.pow(torch.tensor(self.b2, dtype=f32), t))
        mu, nu = {}, {}
        for name, p in params.items():
            g = grads[name]
            if scale is not None:
                g = g * scale.to(g.dtype)
            g32 = g.float()
            if self.quantize_states:
                m = _dequantize(*state.mu[name], g.shape)
                # second moment in sqrt space: int8 linear quantization of
                # sqrt(n) keeps the denominator's relative error bounded
                n = torch.square(_dequantize(*state.nu[name], g.shape))
            else:
                m, n = state.mu[name], state.nu[name]
            m.mul_(self.b1).add_((1 - self.b1) * g32)
            n.mul_(self.b2).add_((1 - self.b2) * g32 * g32)
            u = (m / bc1) / (torch.sqrt(n / bc2) + self.eps)
            if block is not None:
                u = block(name, u)
            p32 = p.float()
            p.copy_(p32 - lr * (u + self.weight_decay * p32))
            if self.quantize_states:
                mu[name], nu[name] = _quantize(m), _quantize(torch.sqrt(n))
            else:
                mu[name], nu[name] = m, n
        return params, AdamWState(step=step, mu=mu, nu=nu)

    def state_specs(self, param_specs: Dict[str, Any]) -> AdamWState:
        """Specs of the optimizer state (a spec is a tuple of ``None | axis
        | tuple of axes``, as ``models.model.param_specs`` gives them): the
        moments mirror the parameters, the step is replicated.  Quantized
        moments, ``(int8 blocks, scale)``, are replicated, as the
        reference's are (their blocks cut across the parameter's shape)."""
        if self.quantize_states:
            q = {k: ((), ()) for k in param_specs}
            return AdamWState(step=(), mu=q, nu=dict(q))
        return AdamWState(step=(), mu=dict(param_specs), nu=dict(param_specs))


# ---------------------------------------------------------------------------
# Error-feedback int8 gradient compression
# ---------------------------------------------------------------------------


def compress_grads(grads: Dict[str, torch.Tensor], residuals: Dict[str, torch.Tensor]):
    """Quantize gradients to int8 blocks with error feedback.  Returns
    ``(quantized dict of (q, scale), new residuals)``."""
    qs, res = {}, {}
    for k, g in grads.items():
        g32 = g.float() + residuals[k]
        qs[k] = _quantize(g32)
        res[k] = g32 - _dequantize(*qs[k], g.shape)
    return qs, res


def decompress_grads(qs: Dict[str, Quantized], shapes: Dict[str, torch.Tensor],
                     dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """``qs`` back to tensors shaped like the tensors of ``shapes``."""
    return {k: _dequantize(q, s, shapes[k].shape, dtype) for k, (q, s) in qs.items()}


def init_residuals(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
