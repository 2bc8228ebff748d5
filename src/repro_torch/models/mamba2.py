"""Mamba-2 / SSD (state-space duality) block (arXiv:2405.21060; a port of
``repro.models.mamba2``).

Training/prefill path: the chunked SSD algorithm — intra-chunk quadratic
('attention-like') term + inter-chunk recurrent state propagation, here a
Python loop over the chunks (the reference scans them).  Memory is
O(S * Q + S/Q * H * P * N) instead of O(S^2).

Decode path: single-token recurrence on the (H, P, N) state with a rolling
depthwise-conv tail — the serve_step cache.

Shapes follow the Mamba-2 reference: d_inner = expand * d_model,
H = d_inner / head_dim heads, B/C shared across heads in n_groups groups.

The fp32 islands are the reference's: the SSD terms, the state, and the
causal conv, whose window is summed in one order by prefill and decode
alike (``_window_sum``), so the two paths agree.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .layers import rms_norm, silu


@dataclass(frozen=True)
class SSMDims:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def in_proj_dim(self) -> int:
        return 2 * self.d_inner + 2 * self.n_groups * self.d_state + self.n_heads


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., Q) -> (..., Q, Q);  out[i, j] = sum_{k in (j, i]} x[k] for
    i >= j, -inf above the diagonal (masked before any ``exp``, so no
    overflow reaches the backward)."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,       # (B, S, H, P)
    dt: torch.Tensor,      # (B, S, H)   post-softplus
    a_log: torch.Tensor,   # (H,)        A = -exp(a_log)
    b: torch.Tensor,       # (B, S, G, N)
    c: torch.Tensor,       # (B, S, G, N)
    chunk: int,
) -> torch.Tensor:
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if s % chunk != 0:
        raise ValueError(f"seq len {s} not divisible by chunk {chunk}")
    nc = s // chunk
    rep = h // g

    A = -torch.exp(a_log.float())                                       # (H,)
    xc = x.reshape(bsz, nc, chunk, h, p).float()
    dtc = dt.reshape(bsz, nc, chunk, h).float()
    bc = b.reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, dim=3).float()  # (B,nc,Q,H,N)
    cc = c.reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, dim=3).float()

    dA = dtc * A                                                         # (B,nc,Q,H)
    dA_cs = torch.cumsum(dA, dim=2)                                      # (B,nc,Q,H)

    # --- intra-chunk (diagonal) term, fp32 as the decode recurrence is
    L = torch.exp(_segsum(dA.transpose(2, 3)))                           # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", cc, bc)                  # (B,nc,H,Q,Q)
    att = scores * L * dtc.transpose(2, 3)[:, :, :, None, :]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", att, xc)

    # --- per-chunk end states
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)               # (B,nc,Q,H)
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", bc, decay_states * dtc, xc)

    # --- inter-chunk recurrence (sequential over chunks)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                          # (B,nc,H)
    h_prev = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    h_in = []
    for i in range(nc):
        h_in.append(h_prev)
        h_prev = h_prev * chunk_decay[:, i, :, None, None] + states[:, i]
    h_in = torch.stack(h_in, dim=1)                                      # (B,nc,H,P,N)

    # --- inter-chunk output: y_off[q] = (C_q . h_in) * exp(dA_cs[q])
    decay_in = torch.exp(dA_cs)                                          # (B,nc,Q,H)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", cc, h_in, decay_in)

    return (y_diag + y_off).to(x.dtype).reshape(bsz, s, h, p)


def _window_sum(windows: list[torch.Tensor], w: torch.Tensor) -> torch.Tensor:
    """sum_i windows[i] * w[i] in fp32, added in order from zero: the one
    dataflow the prefill conv and the decode window share."""
    wf = w.float()
    out = torch.zeros_like(windows[0], dtype=torch.float32)
    for i, xi in enumerate(windows):
        out = out + xi.float() * wf[i]
    return out


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C), w: (K, C) — causal depthwise conv via shift-and-add
    (K is tiny, typically 4).  Accumulates and returns fp32."""
    k, s = w.shape[0], x.shape[1]
    return _window_sum([F.pad(x, (0, 0, k - 1 - i, 0))[:, :s] for i in range(k)], w)


def mamba2_forward(
    x: torch.Tensor,        # (B, S, D)
    p: dict,
    dims: SSMDims,
) -> torch.Tensor:
    bsz, s, _ = x.shape
    di, g, n, h, hd = dims.d_inner, dims.n_groups, dims.d_state, dims.n_heads, dims.head_dim
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    # split points: z (di), xbc (conv_dim), dt (H)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + dims.conv_dim]
    dt = zxbcdt[..., di + dims.conv_dim:]

    # fp32 conv + silu, cast once: the decode window's dataflow
    xbc = silu(_causal_depthwise_conv(xbc, p["conv_w"])).to(x.dtype)
    xs = xbc[..., :di]
    b = xbc[..., di:di + g * n].reshape(bsz, s, g, n)
    c = xbc[..., di + g * n:].reshape(bsz, s, g, n)

    dt = softplus(dt.float() + p["dt_bias"].float())
    y = ssd_chunked(xs.reshape(bsz, s, h, hd), dt, p["a_log"], b, c, min(dims.chunk, s))
    y = y + xs.reshape(bsz, s, h, hd) * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, di)
    y = rms_norm(y * silu(z), p["norm"])
    return y @ p["out_proj"].to(x.dtype)


def mamba2_decode(
    x: torch.Tensor,        # (B, 1, D)
    p: dict,
    dims: SSMDims,
    cache: dict,            # conv (B, K-1, conv_dim), ssm (B, H, P, N) fp32
) -> tuple[torch.Tensor, dict]:
    bsz = x.shape[0]
    di, g, n, h, hd = dims.d_inner, dims.n_groups, dims.d_state, dims.n_heads, dims.head_dim
    zxbcdt = (x @ p["in_proj"].to(x.dtype))[:, 0]
    z = zxbcdt[:, :di]
    xbc_new = zxbcdt[:, di:di + dims.conv_dim]
    dt = zxbcdt[:, di + dims.conv_dim:]

    conv_hist = torch.cat([cache["conv"], xbc_new[:, None, :]], dim=1)     # (B, K, C)
    xbc = silu(_window_sum(list(conv_hist.unbind(1)), p["conv_w"])).to(x.dtype)
    new_conv = conv_hist[:, 1:]

    xs = xbc[:, :di].reshape(bsz, h, hd)
    rep = h // g
    b = xbc[:, di:di + g * n].reshape(bsz, g, n).repeat_interleave(rep, dim=1)   # (B, H, N)
    c = xbc[:, di + g * n:].reshape(bsz, g, n).repeat_interleave(rep, dim=1)

    dt = softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["a_log"].float())
    decay = torch.exp(dt * A[None, :])                                     # (B, H)
    ssm = cache["ssm"] * decay[..., None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dt, xs.float(), b.float())
    y = torch.einsum("bhpn,bhn->bhp", ssm, c.float()).to(x.dtype)
    y = y + xs * p["d_skip"].to(x.dtype)[None, :, None]
    y = y.reshape(bsz, 1, di)
    y = rms_norm(y * silu(z[:, None, :]), p["norm"])
    out = y @ p["out_proj"].to(x.dtype)
    return out, {"conv": new_conv, "ssm": ssm}
