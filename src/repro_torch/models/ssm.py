"""Mamba2 / SSD (state-space duality) blocks, arXiv:2405.21060; the
PyTorch port of the reference's models/ssm.py.

Chunked dual form: within a chunk of length Q the computation is an
attention-like quadratic over the chunk; across chunks a small (H, N, P)
state carries from one chunk to the next. Decode is the O(1) recurrence
  state <- state * exp(dt*A) + dt * B ⊗ x ;  y = C · state + D * x

The projections z, x, B, C and dt are separate leaves, as in the
reference (its in_proj is split so that z and x shard by heads).

Shapes: d_inner = expand * d_model; heads H = d_inner / head_dim P;
B and C live in a single group (G=1) of state size N = cfg.ssm_state.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import ctx as dist_ctx
from .layers import rms_norm


class SSMSpec(NamedTuple):
    d_model: int
    d_inner: int
    n_heads: int
    head_dim: int
    d_state: int
    d_conv: int
    chunk: int

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.d_state


def spec_from_cfg(cfg) -> SSMSpec:
    d_inner = cfg.ssm_expand * cfg.d_model
    return SSMSpec(d_model=cfg.d_model, d_inner=d_inner, n_heads=d_inner // cfg.ssm_head_dim,
                   head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_state, d_conv=cfg.ssm_conv,
                   chunk=cfg.ssm_chunk)


def init_ssm_params(normal, full, n_layers: int, spec: SSMSpec, dtype: torch.dtype) -> dict:
    """The reference's SSM leaves, stacked over ``n_layers``, with its
    scales and constants: ``normal(shape, std, dtype)`` draws a seeded
    leaf, ``full(shape, value, dtype)`` fills one. dt_bias, A_log and D
    are float32."""
    n, k, di, ns, h = n_layers, spec.d_conv, spec.d_inner, spec.d_state, spec.n_heads
    std = 1.0 / math.sqrt(spec.d_model)
    f32 = torch.float32
    return {
        "in_z": normal((n, spec.d_model, di), std, dtype),
        "in_x": normal((n, spec.d_model, di), std, dtype),
        "in_B": normal((n, spec.d_model, ns), std, dtype),
        "in_C": normal((n, spec.d_model, ns), std, dtype),
        "in_dt": normal((n, spec.d_model, h), std, dtype),
        "conv_x_w": full((n, k, di), 0.25, dtype),
        "conv_x_b": full((n, di), 0.0, dtype),
        "conv_B_w": full((n, k, ns), 0.25, dtype),
        "conv_B_b": full((n, ns), 0.0, dtype),
        "conv_C_w": full((n, k, ns), 0.25, dtype),
        "conv_C_b": full((n, ns), 0.0, dtype),
        "dt_bias": full((n, h), 0.0, f32),
        "A_log": full((n, h), 0.0, f32),
        "D": full((n, h), 1.0, f32),
        "norm": full((n, di), 0.0, dtype),
        "out_proj": normal((n, di, spec.d_model), 1.0 / math.sqrt(di), dtype),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv1d. x (B, S, C), w (K, C): K shifted taps
    added in order, as the reference unrolls them."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i: i + x.shape[1], :] * w[i]
    return out + b


def _segsum(a):
    """(..., Q) -> (..., Q, Q) lower-triangular pairwise sums:
    out[i, j] = sum_{m in (j, i]} a[m], -inf above the diagonal. The
    differences of one cumsum, as the reference takes them (this sets the
    rounding)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(q, device=a.device)
    return torch.where(i[:, None] >= i[None, :], diff, -math.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """SSD over a full sequence, chunked.

    x (b, s, h, p), dt (b, s, h) (after softplus), A (h,) negative decay
    rates, B and C (b, s, n), all float32; initial_state (b, h, n, p)
    carried from a previous segment. Returns y (b, s, h, p) and the final
    state (b, h, n, p)."""
    b, s_real, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s_real)
    if s_real % q:
        # Pad to a chunk multiple with dt = 0: a = dt*A = 0 means no decay
        # and no input, so the final state is exact.
        pad = q - s_real % q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    s = x.shape[1]
    nc = s // q

    a = dt * A
    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    ac = a.reshape(b, nc, q, h)
    Bc = B.reshape(b, nc, q, n)
    Cc = C.reshape(b, nc, q, n)

    # Intra-chunk, the quadratic (attention-like) form, in the reference's
    # pairwise contraction order.
    L = torch.exp(_segsum(ac.permute(0, 1, 3, 2)))  # (b, nc, h, q, q)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    m = scores[:, :, None] * L
    m = m * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]  # * dt_j
    y_diag = torch.einsum("bchij,bcjhp->bcihp", m, xc)

    # Each chunk's own state at its end.
    a_cum = torch.cumsum(ac, dim=2)  # (b, nc, q, h)
    a_tail = a_cum[:, :, -1:] - a_cum  # decay from position j to the chunk's end
    wx = (torch.exp(a_tail) * dtc)[..., None] * xc
    states = torch.einsum("bcjn,bcjhp->bchnp", Bc, wx)

    # Across chunks: the state entering each chunk.
    chunk_decay = torch.exp(a_cum[:, :, -1])  # (b, nc, h)
    s_prev = (initial_state.float() if initial_state is not None
              else x.new_zeros((b, h, n, p)))
    entering = []
    for c in range(nc):
        entering.append(s_prev)
        s_prev = s_prev * chunk_decay[:, c, :, None, None] + states[:, c]
    s_prevs = torch.stack(entering, dim=1)  # (b, nc, h, n, p)

    # The entering state's output within each chunk.
    cs = torch.einsum("bcin,bchnp->bcihp", Cc, s_prevs)
    y_off = cs * torch.exp(a_cum)[..., None]
    y = (y_diag + y_off).reshape(b, s, h, p)[:, :s_real]
    return y, s_prev


def ssd(x, dt, A, B, C, chunk: int, initial_state=None):
    """ssd_chunked on a mesh (plain tensors: unchanged): batch-local over
    the data axes, head-local over 'model' when the heads shard there
    (B and C, shared by the heads, are then replicated and their
    gradients partial sums), else replicated over 'model'. A, shared by
    the batch, has a partial gradient over the data axes that shard it."""
    if not any(hasattr(t, "device_mesh") for t in (x, dt, A, B, C)):
        return ssd_chunked(x, dt, A, B, C, chunk, initial_state=initial_state)
    from torch.distributed.tensor import Partial, Replicate, Shard

    heads = dist_ctx.is_sharded(x, 2)
    names = x.device_mesh.mesh_dim_names
    layout = dist_ctx.batch_layout
    xpl, dpl = layout(x, 2 if heads else None), layout(dt, 2 if heads else None)
    apl = tuple(Shard(0) if (n == "model" and heads) else Replicate() for n in names)
    bpl = layout(B)
    spl = layout(x, 1 if heads else None)
    bgrad = tuple(Partial() if (n == "model" and heads) else p for n, p in zip(names, bpl))
    agrad = tuple(Partial() if (n != "model" and p == Shard(0)) else a
                  for n, p, a in zip(names, xpl, apl))

    def run(xx, dd, aa, bb, cc, s0):
        return ssd_chunked(xx, dd, aa, bb, cc, chunk, initial_state=s0)

    return dist_ctx.per_shard(run, (x, dt, A, B, C, initial_state),
                              (xpl, dpl, apl, bpl, bpl, spl), (xpl, spl),
                              grad_specs=(xpl, dpl, agrad, bgrad, bgrad, spl))


def ssm_forward(params: dict, x, spec: SSMSpec, *, initial_state: Optional[Tuple] = None,
                return_state: bool = False):
    """Full-sequence Mamba2 block. x (B, S, D) -> (B, S, D); with
    ``return_state`` also the state (ssd state (B, H, N, P) float32, conv
    tail (B, d_conv - 1, conv_dim) float32, the [x | B | C] channels
    before the conv), from which ``initial_state`` continues."""
    b, s, _ = x.shape
    h, p, n = spec.n_heads, spec.head_dim, spec.d_state

    z = x @ params["in_z"]
    xs_raw = x @ params["in_x"]
    B_raw = x @ params["in_B"]
    C_raw = x @ params["in_C"]
    dt_raw = x @ params["in_dt"]

    raws = (xs_raw, B_raw, C_raw)
    convs = []
    if initial_state is not None:
        tails = torch.split(initial_state[1].to(xs_raw.dtype), [spec.d_inner, n, n], dim=-1)
    for i, (raw, name) in enumerate(zip(raws, "xBC")):
        w, bias = params[f"conv_{name}_w"], params[f"conv_{name}_b"]
        if initial_state is None:
            convs.append(_causal_conv(raw, w, bias))
        else:
            k1 = tails[i].shape[1]
            convs.append(_causal_conv(torch.cat([tails[i], raw], 1), w, bias)[:, k1:])
    xs, Bv, Cv = (F.silu(c) for c in convs)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    # On a mesh, the SSD internals are head-sharded over 'model' (the
    # intra-chunk decay tensors are (B, nc, H, Q, Q)).
    x4 = dist_ctx.constrain("ssm_x4", xs.float().reshape(b, s, h, p))
    dt = dist_ctx.constrain("ssm_heads3", dt)
    y, s_final = ssd(x4, dt, A, Bv.float(), Cv.float(), spec.chunk,
                             initial_state=None if initial_state is None else initial_state[0])
    y = y + params["D"][:, None] * xs.float().reshape(b, s, h, p)
    y = y.reshape(b, s, spec.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"])
    out = y @ params["out_proj"]
    if not return_state:
        return out
    k1 = spec.d_conv - 1
    pre = torch.cat(raws, dim=-1)
    if s < k1:
        prev = (initial_state[1].to(pre.dtype) if initial_state is not None
                else pre.new_zeros((b, k1, pre.shape[-1])))
        pre = torch.cat([prev, pre], dim=1)
    return out, (s_final, pre[:, -k1:].float())


def ssm_decode_step(params: dict, x, state, spec: SSMSpec):
    """One-token decode. x (B, 1, D), state as ssm_forward returns it.
    Returns (y (B, 1, D), the new state)."""
    b = x.shape[0]
    h, p, n = spec.n_heads, spec.head_dim, spec.d_state
    ssm_state, conv_tail = state

    z = x @ params["in_z"]
    x0 = x[:, 0]
    pre = torch.cat([x0 @ params["in_x"], x0 @ params["in_B"], x0 @ params["in_C"]], dim=-1)
    dt_raw = x0 @ params["in_dt"]

    window = torch.cat([conv_tail.to(pre.dtype), pre[:, None]], dim=1)  # (B, K, conv_dim)
    w_all = torch.cat([params["conv_x_w"], params["conv_B_w"], params["conv_C_w"]], dim=-1)
    b_all = torch.cat([params["conv_x_b"], params["conv_B_b"], params["conv_C_b"]], dim=-1)
    conv_out = torch.einsum("bkc,kc->bc", window, w_all) + b_all
    new_tail = window[:, 1:].float()
    xs = F.silu(conv_out[:, : spec.d_inner])
    Bv = F.silu(conv_out[:, spec.d_inner: spec.d_inner + n]).float()
    Cv = F.silu(conv_out[:, spec.d_inner + n:]).float()

    dt = F.softplus(dt_raw.float() + params["dt_bias"])  # (B, H)
    A = -torch.exp(params["A_log"])
    d_a = torch.exp(dt * A)
    xh = xs.float().reshape(b, h, p)
    new_state = (ssm_state * d_a[..., None, None]
                 + torch.einsum("bn,bh,bhp->bhnp", Bv, dt, xh))
    y = torch.einsum("bn,bhnp->bhp", Cv, new_state) + params["D"][:, None] * xh
    y = y.reshape(b, 1, spec.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"])
    return y @ params["out_proj"], (new_state, new_tail)


def init_ssm_state(batch: int, spec: SSMSpec, device=None):
    """Zero state (ssd state, conv tail) for ``batch`` sequences, float32."""
    return (torch.zeros((batch, spec.n_heads, spec.d_state, spec.head_dim), device=device),
            torch.zeros((batch, spec.d_conv - 1, spec.conv_dim), device=device))
