"""State-space and recurrent mixers: Mamba, mLSTM, sLSTM.

Counterpart of ``src/repro/models/ssm.py``.  Each mixer is a pre-norm
sub-block with the model's block interface (``forward``, ``init_cache``,
``prefill``, ``decode_step``), its leaves named as the reference's, and the
reference's casts step for step: the model runs in bf16 on the card, so
where a value is rounded matters as much as how it is computed.

* **Mamba** (selective SSM, Mamba-1).  The sequence runs in chunks of
  ``ssm_chunk`` steps: a Python loop carries the (B, d_inner, d_state) state
  from chunk to chunk, and within a chunk a log-step scan (``ceil(log2 c)``
  passes of tensor ops) applies the reference's combine ``(Aa Ab, Ba Ab +
  Bb)``.  PyTorch has no ``associative_scan``; the log-step scan sums in
  another order than XLA's tree, so the two agree by tolerance, not by bits.
  ``deltaA`` and ``deltaBx`` are formed a chunk at a time from the same
  elementwise ops: the reference materializes them for the whole sequence,
  (B, T, d_inner, d_state), 8.6 GB in fp32 for ``deltaA`` alone at Jamba's
  width and a 4 x 2,048 batch.
* **mLSTM** (xLSTM matrix memory), the chunkwise-parallel stabilized form:
  (c x c) products inside a chunk, the (H, dh, dh) state carried between
  chunks; the running max is ``torch.cummax`` (exact).
* **sLSTM** (scalar memory, block-diagonal recurrence): a Python loop over
  time of :func:`_slstm_cell`, as the reference's ``lax.scan`` is, run
  eagerly (some 25 launches a step on the card).  With ``cost_mode`` (the
  config's ``unroll_scan``) it is the reference's FLOP-equivalent parallel
  form instead, the dry run's cost proxy: the gates see the normed input in
  place of ``h_{t-1}``, so c and n are linear recurrences that the
  log-step scan computes.  Not the sLSTM's values: a cost stand-in.

``prefill`` keeps the reference's documented serving limitation: it runs the
full forward and returns a *fresh* state (zeros), not the state at the end of
the prompt.

Under a model axis (:mod:`repro_torch.runtime.tensor_parallel`) each mixer
reads its normed input through ``f`` and sums its output projection by
``g``; between them a rank runs its block of Mamba's ``d_inner`` channels,
or its mLSTM or sLSTM heads, read from its weights' shapes.  Mamba's
``xin @ w_x`` and the mLSTM's gates and ``out_norm`` statistics are partial
sums every rank uses, summed both ways (``tensor_parallel.sum_over_model``);
the sLSTM's block-diagonal recurrence runs a rank's heads with no
collective in its time loop.  A rank's decode state holds its channels or
heads.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..runtime import tensor_parallel as tp
from . import layers


def _check_chunk(T: int, chunk: int) -> None:
    """The reference's rule (an assert there): the sequence is a whole
    number of chunks; nothing is padded."""
    if T % chunk:
        raise ValueError(f"sequence length {T} is not a multiple of the chunk {chunk}")


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, T, di); w: (k, di); k shift-multiply-adds."""
    k, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + xp[:, j:j + T, :] * w[j]
    return out + b


def _conv_step(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The causal conv at the newest step of ``window`` (B, k, di): (B, 1, di)."""
    return (window * w[None]).sum(dim=1, keepdim=True) + b


def _drawn(gen, shape, std: float, dtype, device) -> nn.Parameter:
    """N(0, std^2) drawn from ``gen`` in fp32, or uninitialized without one."""
    if gen is None:
        return layers.param(torch.empty(tuple(shape), dtype=dtype, device=device))
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    return layers.param((w.normal_(0.0, 1.0, generator=gen) * std).to(dtype))


# ===========================================================================
# Mamba (selective SSM)
# ===========================================================================


class MambaDims(NamedTuple):
    d_inner: int  # expansion of d_model (typically 2x)
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


def mamba_dt_rank(d_model: int, dims: MambaDims) -> int:
    return dims.dt_rank or math.ceil(d_model / 16)


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv - 1, di): trailing inputs
    h: torch.Tensor  # (B, di, ds)


def _log_step_scan(A: torch.Tensor, Bx: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``h_t = A_t h_{t-1} + Bx_t`` over axis 1 from
    ``h = 0``: ``ceil(log2 c)`` passes, each combining every step with the
    one ``s`` before it by ``(Aa Ab, Ba Ab + Bb)`` (Hillis-Steele).
    Out of place, so autograd can differentiate it."""
    c = A.shape[1]
    s = 1
    while s < c:
        Bx = torch.cat([Bx[:, :s], Bx[:, :-s] * A[:, s:] + Bx[:, s:]], dim=1)
        if 2 * s < c:  # the last pass needs no decays
            A = torch.cat([A[:, :s], A[:, :-s] * A[:, s:]], dim=1)
        s *= 2
    return Bx


def _chunk_scan(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
                h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk: the carried state ``h`` (B, di, ds) folded into the first
    step, the chunk's states, and ``y_t = (h_t * C_t).sum(-1)``.  Returns
    (the state at the chunk's end, y (B, c, di))."""
    dBx = torch.cat([dBx[:, :1] + dA[:, :1] * h[:, None], dBx[:, 1:]], dim=1)
    hs = _log_step_scan(dA, dBx)
    return hs[:, -1], torch.einsum("btds,bts->btd", hs, C)


def _ssm_scan_chunked(deltaA: torch.Tensor, deltaBx: torch.Tensor, C: torch.Tensor,
                      chunk: int) -> torch.Tensor:
    """``h_t = deltaA_t * h_{t-1} + deltaBx_t``; ``y_t = (h_t * C_t).sum(-1)``.

    deltaA, deltaBx: (B, T, di, ds); C: (B, T, ds).  The reference's function
    on whole-sequence inputs (``Mamba.forward`` forms them a chunk at a
    time): a log-step scan within each chunk, a loop across chunks."""
    B, T, di, ds = deltaA.shape
    _check_chunk(T, chunk)
    h = torch.zeros((B, di, ds), dtype=deltaA.dtype, device=deltaA.device)
    ys = []
    for s in range(0, T, chunk):
        h, y = _chunk_scan(deltaA[:, s:s + chunk], deltaBx[:, s:s + chunk],
                           C[:, s:s + chunk], h)
        ys.append(y)
    return torch.cat(ys, dim=1)


class Mamba(nn.Module):
    """Pre-norm Mamba mixer: ``x + w_out(ssm(conv(w_in(norm(x)))) * silu(z))``.
    Leaves: ``norm_scale w_in conv_w conv_b w_x w_dt dt_bias A_log D w_out``."""

    def __init__(self, d_model: int, dims: MambaDims, chunk: int, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dims, self.chunk = dims, chunk
        di, ds = dims.d_inner, dims.d_state
        dtr = mamba_dt_rank(d_model, dims)
        self.norm_scale = layers.param(layers.init_rms_scale(d_model, dtype, device))
        self.w_in = layers.dense_param(gen, (d_model, 2 * di), dtype, device)  # [x | z]
        self.conv_w = _drawn(gen, (dims.d_conv, di), 0.1, dtype, device)
        self.conv_b = layers.param(torch.zeros((di,), dtype=dtype, device=device))
        self.w_x = layers.dense_param(gen, (di, dtr + 2 * ds), dtype, device)  # dt, B, C
        self.w_dt = layers.dense_param(gen, (dtr, di), dtype, device)
        dt_bias = torch.empty((di,), dtype=torch.float32, device=device)
        if gen is not None:
            dt_bias.uniform_(math.log(1e-3), math.log(1e-1), generator=gen)
            dt_bias = torch.log(torch.expm1(torch.exp(dt_bias)))
        self.dt_bias = layers.param(dt_bias.to(dtype))
        # S4D-real initialization of A
        A = torch.arange(1, ds + 1, dtype=torch.float32, device=device).expand(di, ds)
        self.A_log = layers.param(torch.log(A).to(dtype))
        self.D = layers.param(torch.ones((di,), dtype=dtype, device=device))
        self.w_out = layers.dense_param(gen, (di, d_model), dtype, device)

    def _inner(self, xin: torch.Tensor):
        """dt (B, T, di) and the input-dependent B, C (B, T, ds) of the
        convolved input (under a model axis, dt of this rank's channels; the
        product with ``w_x`` over them is a partial sum of every rank's B, C
        and step sizes, summed both ways)."""
        dtr, ds = self.w_dt.shape[0], self.dims.d_state
        dt_low, Bc, Cc = torch.split(tp.sum_over_model(xin @ self.w_x), [dtr, ds, ds], dim=-1)
        # PyTorch's softplus turns linear above threshold=20, where
        # jax.nn.softplus adds log1p(exp(-x)) < 2.1e-9: below fp32's rounding
        # of any x > 20 (half an ulp there is 9.5e-7)
        return F.softplus(dt_low @ self.w_dt + self.dt_bias), Bc, Cc

    def _decays(self, dt: torch.Tensor) -> torch.Tensor:
        """exp(dt A), (..., di, ds), in fp32 (rounded by the caller)."""
        A = -torch.exp(self.A_log.float())
        return torch.exp(dt[..., None].float() * A)

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor] = None,
                use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor, None]:
        """x: (B, T, d_model), T a multiple of ``min(chunk, T)``."""
        B, T, _ = x.shape
        chunk = min(self.chunk, T)
        _check_chunk(T, chunk)
        h = tp.copy_to_model(layers.rms_norm(x, self.norm_scale))
        xin, z = (h @ self.w_in).chunk(2, dim=-1)
        xin = F.silu(_causal_conv(xin, self.conv_w, self.conv_b))
        dt, Bc, Cc = self._inner(xin)
        dtx = dt * xin
        state = torch.zeros((B, xin.shape[-1], self.dims.d_state), dtype=x.dtype,
                            device=x.device)
        ys = []
        for s in range(0, T, chunk):
            c = slice(s, s + chunk)
            dA = self._decays(dt[:, c]).to(x.dtype)
            dBx = dtx[:, c, :, None] * Bc[:, c, None, :]
            state, y = _chunk_scan(dA, dBx, Cc[:, c], state)
            ys.append(y)
        y = torch.cat(ys, dim=1) + self.D * xin
        y = y * F.silu(z)
        return x + tp.reduce_from_model(y @ self.w_out), None

    def init_cache(self, B: int, S_max: int, dtype, device) -> MambaState:
        """A fresh state of the channels this rank holds."""
        d, di = self.dims, self.D.shape[0]
        return MambaState(
            conv=torch.zeros((B, d.d_conv - 1, di), dtype=dtype, device=device),
            h=torch.zeros((B, di, d.d_state), dtype=dtype, device=device))

    def prefill(self, x: torch.Tensor, positions: torch.Tensor, S_max: int,
                use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor, MambaState]:
        """The full forward and a fresh state (the reference's documented
        serving limitation)."""
        return self(x)[0], self.init_cache(x.shape[0], S_max, x.dtype, x.device)

    def decode_step(self, x: torch.Tensor, state: MambaState,
                    pos: torch.Tensor) -> Tuple[torch.Tensor, MambaState]:
        """One-token recurrence, x: (B, 1, d_model); ``state`` is updated in
        place."""
        h = layers.rms_norm(x, self.norm_scale)
        xin, z = (h @ self.w_in).chunk(2, dim=-1)  # (B, 1, di)
        window = torch.cat([state.conv, xin], dim=1)  # (B, k, di)
        xin_c = F.silu(_conv_step(window, self.conv_w, self.conv_b))
        dt, Bc, Cc = self._inner(xin_c)  # (B, 1, di), (B, 1, ds)
        dA = self._decays(dt)[:, 0]
        dBx = ((dt * xin_c)[..., None] * Bc[:, :, None, :])[:, 0]
        h_new = dA.to(x.dtype) * state.h + dBx.to(x.dtype)
        y = torch.einsum("bds,bs->bd", h_new, Cc[:, 0])[:, None, :]
        y = (y + self.D * xin_c) * F.silu(z)
        state.conv.copy_(window[:, 1:])
        state.h.copy_(h_new)
        return x + tp.reduce_from_model(y @ self.w_out), state


# ===========================================================================
# mLSTM (xLSTM matrix memory, chunkwise-parallel stabilized form)
# ===========================================================================


class MLSTMDims(NamedTuple):
    d_inner: int  # up-projection (typically 2 x d_model)
    n_heads: int
    d_conv: int = 4


class MLSTMState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv - 1, di)
    C: torch.Tensor  # (B, H, dh, dh)
    n: torch.Tensor  # (B, H, dh)
    m: torch.Tensor  # (B, H) fp32


def _headed_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Block-diagonal per-head projection.  x: (..., di); w: (H, dh, dh)."""
    H, dh = w.shape[0], w.shape[-1]
    xs = x.reshape(*x.shape[:-1], H, dh)
    return torch.einsum("...hd,hde->...he", xs, w).reshape(x.shape)


def _mlstm_chunk(C_st, n_st, m_st, qc, kc, vc, li, lf):
    """One chunk of :func:`_mlstm_chunk_scan`: (h (B, H, c, dh), and the
    state at the chunk's end, C and n rounded to their type, m fp32)."""
    c, dh = qc.shape[-2], qc.shape[-1]
    scale = 1.0 / (dh ** 0.5)
    b = torch.cumsum(lf, dim=-1)  # (B, H, c) inclusive log-decay
    u = li - b  # log(i_t) - b_t
    Mrun = torch.cummax(u, dim=-1).values  # running max
    m_j = b + torch.maximum(m_st[..., None], Mrun)  # stabilizer per position
    s_state = torch.exp(m_st[..., None] + b - m_j)  # inter-chunk contribution scale
    # intra-chunk decay D[j, t] = exp(b_j - b_t + li_t - m_j), t <= j
    Dlog = b[..., :, None] + u[..., None, :] - m_j[..., :, None]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=qc.device))
    D = torch.where(tri, torch.exp(Dlog), 0.0)
    S = torch.einsum("bhjd,bhtd->bhjt", qc, kc) * scale * D  # fp32
    qs = qc * scale
    num = torch.einsum("bhjt,bhtd->bhjd", S, vc.float()) + s_state[..., None] * torch.einsum(
        "bhjd,bhde->bhje", qs, C_st)
    den = S.sum(-1) + s_state * torch.einsum("bhjd,bhd->bhj", qs, n_st)
    h = (num / torch.maximum(den.abs(), torch.exp(-m_j))[..., None]).to(qc.dtype)
    # the state at the end of the chunk
    btot = b[..., -1]
    m_new = btot + torch.maximum(m_st, Mrun[..., -1])
    w_t = torch.exp(btot[..., None] - b + li - m_new[..., None])  # (B, H, c)
    carry = torch.exp(m_st + btot - m_new)
    kf = w_t[..., None] * kc.float()
    C_new = carry[..., None, None] * C_st + torch.einsum("bhtd,bhte->bhde", kf, vc.float())
    n_new = carry[..., None] * n_st + kf.sum(dim=2)
    return h, C_new.to(C_st.dtype), n_new.to(n_st.dtype), m_new


def _mlstm_chunk_scan(q, k, v, log_i, log_f, chunk: int) -> torch.Tensor:
    """Chunkwise stabilized mLSTM.  q, k, v: (B, H, T, dh); log_i, log_f:
    (B, H, T) fp32 (log input / forget gate).  Returns h (B, H, T, dh)."""
    B, H, T, dh = q.shape
    _check_chunk(T, chunk)
    C_st = torch.zeros((B, H, dh, dh), dtype=q.dtype, device=q.device)
    n_st = torch.zeros((B, H, dh), dtype=q.dtype, device=q.device)
    m_st = torch.full((B, H), -1e30, dtype=torch.float32, device=q.device)
    hs = []
    for s in range(0, T, chunk):
        c = slice(s, s + chunk)
        h, C_st, n_st, m_st = _mlstm_chunk(C_st, n_st, m_st, q[:, :, c], k[:, :, c],
                                           v[:, :, c], log_i[..., c], log_f[..., c])
        hs.append(h)
    return torch.cat(hs, dim=2)


class MLSTM(nn.Module):
    """Pre-norm mLSTM mixer.  Leaves: ``norm_scale w_up conv_w conv_b wq wk
    wv w_if b_i b_f out_norm w_down`` (q/k/v per-head block-diagonal,
    (H, dh, dh))."""

    def __init__(self, d_model: int, dims: MLSTMDims, chunk: int, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dims, self.chunk = dims, chunk
        di, H = dims.d_inner, dims.n_heads
        dh = di // H
        self.norm_scale = layers.param(layers.init_rms_scale(d_model, dtype, device))
        self.w_up = layers.dense_param(gen, (d_model, 2 * di), dtype, device)  # [x | z]
        self.conv_w = _drawn(gen, (dims.d_conv, di), 0.1, dtype, device)
        self.conv_b = layers.param(torch.zeros((di,), dtype=dtype, device=device))
        self.wq = _drawn(gen, (H, dh, dh), 1.0 / dh ** 0.5, dtype, device)
        self.wk = _drawn(gen, (H, dh, dh), 1.0 / dh ** 0.5, dtype, device)
        self.wv = _drawn(gen, (H, dh, dh), 1.0 / dh ** 0.5, dtype, device)
        self.w_if = layers.dense_param(gen, (di, 2 * H), dtype, device)  # input/forget gates
        self.b_i = layers.param(torch.zeros((H,), dtype=dtype, device=device))
        self.b_f = layers.param(torch.full((H,), 3.0, dtype=dtype, device=device))
        self.out_norm = layers.param(layers.init_rms_scale(di, dtype, device))
        self.w_down = layers.dense_param(gen, (di, d_model), dtype, device)

    def _heads(self) -> Tuple[int, int]:
        """The heads this rank computes (all of them on one device) and the
        head size."""
        return self.wq.shape[0], self.wq.shape[-1]

    def _gates(self, xc: torch.Tensor) -> torch.Tensor:
        """The input and forget gates' pre-activations of this rank's heads,
        (..., 2, H): under a model axis ``xc`` holds the rank's channels, so
        its product with their rows of ``w_if`` is a partial sum of every
        head's gates, summed both ways."""
        w_if = tp.local_block(self.w_if, 0, xc.shape[-1])
        gates = tp.sum_over_model(xc @ w_if)
        gates = gates.reshape(*gates.shape[:-1], 2, self.dims.n_heads)
        return tp.local_block(gates, -1, self._heads()[0])

    def _out_norm(self, out: torch.Tensor) -> torch.Tensor:
        """``rms_norm(out, out_norm)`` over the whole ``d_inner``: under a
        model axis ``out`` holds the rank's channels, and their fp32 sum of
        squares is summed both ways before the ``rsqrt``."""
        if tp.active() is None:
            return layers.rms_norm(out, self.out_norm)
        xf = out.float()
        var = tp.sum_over_model(torch.sum(xf * xf, dim=-1, keepdim=True)) / self.dims.d_inner
        scale = tp.local_block(self.out_norm, 0, out.shape[-1])
        return (xf * torch.rsqrt(var + 1e-6)).to(out.dtype) * scale

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor] = None,
                use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor, None]:
        B, T, _ = x.shape
        H, dh = self._heads()
        h = tp.copy_to_model(layers.rms_norm(x, self.norm_scale))
        xin, z = (h @ self.w_up).chunk(2, dim=-1)
        xc = F.silu(_causal_conv(xin, self.conv_w, self.conv_b))

        def heads(t):
            return t.reshape(B, T, H, dh).transpose(1, 2)

        q = heads(_headed_proj(xc, self.wq))
        k = heads(_headed_proj(xc, self.wk))
        v = heads(_headed_proj(xin, self.wv))
        gates = self._gates(xc).permute(0, 3, 2, 1)  # (B, H, 2, T)
        b_i, b_f = tp.local_block(self.b_i, 0, H), tp.local_block(self.b_f, 0, H)
        log_i = (gates[:, :, 0] + b_i[None, :, None]).float()
        log_f = F.logsigmoid(gates[:, :, 1] + b_f[None, :, None]).float()
        out = _mlstm_chunk_scan(q, k, v, log_i, log_f, min(self.chunk, T))
        out = out.transpose(1, 2).reshape(B, T, H * dh)
        out = self._out_norm(out) * F.silu(z)
        return x + tp.reduce_from_model(out @ self.w_down), None

    def init_cache(self, B: int, S_max: int, dtype, device) -> MLSTMState:
        """A fresh state of the heads this rank holds."""
        H, dh = self._heads()
        return MLSTMState(
            conv=torch.zeros((B, self.dims.d_conv - 1, H * dh), dtype=dtype, device=device),
            C=torch.zeros((B, H, dh, dh), dtype=dtype, device=device),
            n=torch.zeros((B, H, dh), dtype=dtype, device=device),
            m=torch.full((B, H), -1e30, dtype=torch.float32, device=device))

    def prefill(self, x: torch.Tensor, positions: torch.Tensor, S_max: int,
                use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor, MLSTMState]:
        """The full forward and a fresh state, as the reference's."""
        return self(x)[0], self.init_cache(x.shape[0], S_max, x.dtype, x.device)

    def decode_step(self, x: torch.Tensor, state: MLSTMState,
                    pos: torch.Tensor) -> Tuple[torch.Tensor, MLSTMState]:
        """One-token recurrence; ``state`` is updated in place."""
        B = x.shape[0]
        H, dh = self._heads()
        h = layers.rms_norm(x, self.norm_scale)
        xin, z = (h @ self.w_up).chunk(2, dim=-1)  # (B, 1, di)
        window = torch.cat([state.conv, xin], dim=1)
        xc = F.silu(_conv_step(window, self.conv_w, self.conv_b))
        q = _headed_proj(xc, self.wq).reshape(B, H, dh)
        k = _headed_proj(xc, self.wk).reshape(B, H, dh)
        v = _headed_proj(xin, self.wv).reshape(B, H, dh)
        gates = self._gates(xc).reshape(B, 2, H)
        li = (gates[:, 0] + tp.local_block(self.b_i, 0, H)).float()  # (B, H)
        lf = F.logsigmoid(gates[:, 1] + tp.local_block(self.b_f, 0, H)).float()
        m_new = torch.maximum(lf + state.m, li)
        i_p = torch.exp(li - m_new)[..., None]
        f_p = torch.exp(lf + state.m - m_new)[..., None]
        scale = 1.0 / (dh ** 0.5)
        C_new = (f_p[..., None] * state.C
                 + i_p[..., None] * k[..., :, None] * v[..., None, :]).to(state.C.dtype)
        n_new = (f_p * state.n + i_p * k).to(state.n.dtype)
        qs = q * scale
        num = torch.einsum("bhd,bhde->bhe", qs, C_new)
        den = torch.einsum("bhd,bhd->bh", qs, n_new)
        hout = (num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]).to(x.dtype)
        out = self._out_norm(hout.reshape(B, 1, H * dh)) * F.silu(z)
        state.conv.copy_(window[:, 1:])
        state.C.copy_(C_new)
        state.n.copy_(n_new)
        state.m.copy_(m_new)
        return x + tp.reduce_from_model(out @ self.w_down), state


# ===========================================================================
# sLSTM (scalar memory, exponential gating, block-diagonal recurrence)
# ===========================================================================


class SLSTMDims(NamedTuple):
    n_heads: int


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, d)
    n: torch.Tensor  # (B, d)
    h: torch.Tensor  # (B, d)
    m: torch.Tensor  # (B, d) fp32


def _slstm_init_state(B: int, d_model: int, dtype, device) -> SLSTMState:
    def z():
        return torch.zeros((B, d_model), dtype=dtype, device=device)

    return SLSTMState(c=z(), n=z(), h=z(),
                      m=torch.full((B, d_model), -1e30, dtype=torch.float32, device=device))


def _slstm_cell(r: torch.Tensor, xw: torch.Tensor, state: SLSTMState) -> SLSTMState:
    """One step.  xw: the precomputed ``x @ w + b``, (B, 4d); r: (H, dh, 4dh).
    ``li``, ``lf`` and ``m`` in fp32; c, n and h rounded to their type."""
    B, d4 = xw.shape
    d = d4 // 4
    H = r.shape[0]
    dh = d // H
    rec = torch.einsum("bhd,hde->bhe", state.h.reshape(B, H, dh), r)
    # heads own contiguous [i|f|z|o] slices of 4*dh each: to the global
    # [i|f|z|o] layout of xw
    rec = rec.reshape(B, H, 4, dh).transpose(1, 2).reshape(B, 4 * d)
    li, lf, z_in, o_in = (xw + rec).chunk(4, dim=-1)
    li = li.float()
    lf = F.logsigmoid(lf.float())
    m_new = torch.maximum(lf + state.m, li)
    i_p = torch.exp(li - m_new)
    f_p = torch.exp(lf + state.m - m_new)
    z_t = torch.tanh(z_in)
    o_t = torch.sigmoid(o_in)
    c_new = f_p * state.c + i_p * z_t
    n_new = f_p * state.n + i_p
    h_new = o_t * (c_new / torch.clamp(n_new, min=1e-6))
    return SLSTMState(c=c_new.to(state.c.dtype), n=n_new.to(state.n.dtype),
                      h=h_new.to(state.h.dtype), m=m_new)


class SLSTM(nn.Module):
    """Pre-norm sLSTM mixer.  Leaves: ``norm_scale w r b w_out`` (``w`` packs
    the [i|f|z|o] gates, ``r`` the per-head recurrent weights (H, dh, 4dh),
    ``b`` the gate biases with the forget slice at 3.0)."""

    def __init__(self, d_model: int, dims: SLSTMDims, dtype, device,
                 gen: Optional[torch.Generator] = None, cost_mode: bool = False):
        super().__init__()
        self.dims, self.cost_mode = dims, cost_mode
        H = dims.n_heads
        dh = d_model // H
        self.norm_scale = layers.param(layers.init_rms_scale(d_model, dtype, device))
        self.w = layers.dense_param(gen, (d_model, 4 * d_model), dtype, device)  # i,f,z,o
        self.r = _drawn(gen, (H, dh, 4 * dh), 1.0 / dh ** 0.5, dtype, device)
        b = torch.zeros((4 * d_model,), dtype=dtype, device=device)
        b[d_model:2 * d_model] = 3.0  # forget bias
        self.b = layers.param(b)
        self.w_out = layers.dense_param(gen, (d_model, d_model), dtype, device)

    def _r(self) -> torch.Tensor:
        """The recurrent weights of this rank's heads (all on one device):
        ``w`` holds ``[i_r | f_r | z_r | o_r]``, 4 x its heads' channels."""
        return tp.local_block(self.r, 0, self.w.shape[1] // 4 // self.r.shape[1])

    def _xw(self, h: torch.Tensor) -> torch.Tensor:
        """``h @ w + b``, the gates' input part, of this rank's heads."""
        return h @ self.w + tp.local_parts(self.b, 4)

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor] = None,
                use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor, None]:
        """The time loop: one :func:`_slstm_cell` a step, as the reference's
        ``lax.scan``; with ``cost_mode`` the parallel proxy
        (:meth:`_cost_forward`).  Under a model axis a rank's heads, with no
        collective inside the loop."""
        B, T, _ = x.shape
        h = tp.copy_to_model(layers.rms_norm(x, self.norm_scale))
        xw = self._xw(h)  # (B, T, 4d)
        if self.cost_mode:
            return self._cost_forward(x, h, xw), None
        r = self._r()
        state = _slstm_init_state(B, xw.shape[-1] // 4, x.dtype, x.device)
        hs: List[torch.Tensor] = []
        for t in range(T):
            state = _slstm_cell(r, xw[:, t], state)
            hs.append(state.h)
        return x + tp.reduce_from_model(torch.stack(hs, dim=1) @ self.w_out), None

    def _cost_forward(self, x: torch.Tensor, h: torch.Tensor,
                      xw: torch.Tensor) -> torch.Tensor:
        """The reference's ``cost_mode``: the per-head recurrent product and
        the gates of every step at once, ``h`` (the normed input) standing in
        for ``h_{t-1}``; then ``c_t = f_t c_{t-1} + i_t z_t`` and ``n_t = f_t
        n_{t-1} + i_t`` by the log-step scan.  Its per-step operations are
        the time loop's; its values are not the sLSTM's.  Under a model axis
        a rank's heads read their channels of ``h``, and the input gates'
        maximum is the group's (without gradient)."""
        B, T, _ = x.shape
        r = self._r()
        H, dh = r.shape[0], r.shape[1]
        d = H * dh
        hl = tp.local_block(h, -1, d)
        rec = torch.einsum("bthd,hde->bthe", hl.reshape(B, T, H, dh), r)
        rec = rec.reshape(B, T, H, 4, dh).transpose(2, 3).reshape(B, T, 4 * d)
        li, lf, z_in, o_in = (xw + rec).chunk(4, dim=-1)
        lf = F.logsigmoid(lf.float())
        i_p = torch.exp(li.float() - tp.max_over_model(torch.amax(li)).float())
        f_p = torch.exp(lf)
        z_t = torch.tanh(z_in)
        o_t = torch.sigmoid(o_in)
        c_all = _log_step_scan(f_p, i_p * z_t.float())
        n_all = _log_step_scan(f_p, i_p)
        hs = o_t * (c_all / torch.clamp(n_all, min=1e-6)).to(x.dtype)
        return x + tp.reduce_from_model(hs @ self.w_out)

    def init_cache(self, B: int, S_max: int, dtype, device) -> SLSTMState:
        """A fresh state of the channels of this rank's heads."""
        return _slstm_init_state(B, self.w.shape[1] // 4, dtype, device)

    def prefill(self, x: torch.Tensor, positions: torch.Tensor, S_max: int,
                use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor, SLSTMState]:
        """The full forward and a fresh state, as the reference's."""
        return self(x)[0], self.init_cache(x.shape[0], S_max, x.dtype, x.device)

    def decode_step(self, x: torch.Tensor, state: SLSTMState,
                    pos: torch.Tensor) -> Tuple[torch.Tensor, SLSTMState]:
        """One step; ``state`` is updated in place."""
        xw = self._xw(layers.rms_norm(x, self.norm_scale))[:, 0]  # (B, 4d)
        new = _slstm_cell(self._r(), xw, state)
        for old, val in zip(state, new):
            old.copy_(val)
        return x + tp.reduce_from_model(new.h[:, None, :] @ self.w_out), state
