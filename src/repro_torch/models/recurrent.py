"""Recurrent blocks: xLSTM (mLSTM chunkwise-parallel + sLSTM) and RG-LRU.

The port of ``repro/models/recurrent.py``.  The state is sharded over the
model axis and each recurrence is collective-free:

  mLSTM  — matrix memory C (d_v × d_k) with d_v TP-sharded, d_k full.
  sLSTM  — diagonal-recurrence variant (the block-diagonal R of the paper
           degenerates to its diagonal here, as in the reference), hidden
           units TP-sharded.
  RG-LRU — elementwise gated linear recurrence (Griffin), width
           TP-sharded, trained with a log-depth associative scan.

The training path of mLSTM is the stabilised chunkwise-parallel form; the
exact step-by-step scan is kept as the numerical oracle.  ``lax.scan``
becomes a Python loop over the sequence (or the chunks).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import MeshAxes, col_linear, fsdp_gather, row_linear


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


# ===========================================================================
# mLSTM
# ===========================================================================

def _mlstm_gates(p, x, ax: MeshAxes):
    """i~, f~ pre-activations: (B, S, H) from the block input (full D),
    in f32."""
    wi = fsdp_gather(p["w_i"], ax, 0).float()
    wf = fsdp_gather(p["w_f"], ax, 0).float()
    xf = x.float()
    return xf @ wi + p["b_i"].float(), xf @ wf + p["b_f"].float()


def _mlstm_qkv(p, x, cfg: ModelConfig, ax: MeshAxes):
    """q,k: (B,S,H,dk) full; v: (B,S,H,dv_loc) TP-sharded."""
    H = cfg.n_heads
    inner = 2 * cfg.d_model
    dk = inner // H
    q = col_linear(x, p["w_q"], ax, fsdp_dim=0)   # replicated over model
    k = col_linear(x, p["w_k"], ax, fsdp_dim=0)
    v = col_linear(x, p["w_v"], ax, fsdp_dim=0)   # TP-sharded inner
    B, S = x.shape[:2]
    q = q.reshape(B, S, H, dk) * (dk ** -0.5)
    k = k.reshape(B, S, H, dk)
    dv_loc = v.shape[-1] // H
    v = v.reshape(B, S, H, dv_loc)
    return q, k, v


def mlstm_scan_ref(q, k, v, it, ft, *, carry=None):
    """Exact stabilised mLSTM recurrence (oracle).  Shapes:
    q/k (B,S,H,dk), v (B,S,H,dv), it/ft (B,S,H).  Returns h (B,S,H,dv)
    and the carry (C, n, m)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    if carry is None:
        carry = (torch.zeros((B, H, dv, dk), device=dev),
                 torch.zeros((B, H, dk), device=dev),
                 torch.full((B, H), -1e30, device=dev))
    C, n, m = carry
    q, k, v = q.float(), k.float(), v.float()
    hs = []
    for t in range(S):
        qt, kt, vt, i_t, f_t = q[:, t], k[:, t], v[:, t], it[:, t], ft[:, t]
        logf = log_sigmoid(f_t)                              # (B,H)
        m_new = torch.maximum(logf + m, i_t)
        fp = torch.exp(logf + m - m_new)
        ip = torch.exp(i_t - m_new)
        C = fp[..., None, None] * C + ip[..., None, None] * \
            torch.einsum("bhv,bhk->bhvk", vt, kt)
        n = fp[..., None] * n + ip[..., None] * kt
        num = torch.einsum("bhvk,bhk->bhv", C, qt)
        den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, qt)),
                            torch.exp(-m_new))[..., None]
        m = m_new
        hs.append(num / den)
    return torch.stack(hs, dim=1), (C, n, m)                 # (B,S,H,dv)


def mlstm_chunked(q, k, v, it, ft, *, chunk: int = 128):
    """Stabilised chunkwise-parallel mLSTM (training fast path)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    L = min(chunk, S)
    assert S % L == 0, "sequence must divide the chunk size"
    NC = S // L
    dev = q.device

    def resh(x):
        return x.float().reshape(B, NC, L, *x.shape[2:])

    qs, ks, vs, its, fts = map(resh, (q, k, v, it, ft))

    C = torch.zeros((B, H, dv, dk), device=dev)
    n = torch.zeros((B, H, dk), device=dev)
    m = torch.full((B, H), -1e30, device=dev)

    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))
    neg = torch.tensor(-torch.inf, device=dev)

    hs = []
    for c in range(NC):
        qc, kc, vc, ic, fc = (qs[:, c], ks[:, c], vs[:, c], its[:, c],
                              fts[:, c])          # (B,L,H,*) / (B,L,H)
        logf = log_sigmoid(fc)                    # (B,L,H)
        b = torch.cumsum(logf, dim=1)             # inclusive cumsum
        # intra-chunk log weights: g[i,j] = b_i - b_j + i_j  (j <= i)
        gi = b[:, :, None, :] - b[:, None, :, :] + ic[:, None, :, :]
        gi = torch.where(tri[None, :, :, None], gi, neg)       # (B,L,L,H)
        inter = b + m[:, None, :]                              # (B,L,H)
        m_i = torch.maximum(inter, torch.amax(gi, dim=2))      # (B,L,H)
        w_intra = torch.exp(gi - m_i[:, :, None, :])           # (B,L,L,H)
        w_inter = torch.exp(inter - m_i)                       # (B,L,H)

        scores = torch.einsum("blhk,bjhk->bljh", qc, kc)       # (B,L,L,H)
        num = torch.einsum("bljh,bljh,bjhv->blhv", scores, w_intra, vc) \
            + torch.einsum("blh,bhvk,blhk->blhv", w_inter, C, qc)
        # denominator uses n_t = Σ weights·k (+ inter part), dotted with q
        den_intra = torch.einsum("bljh,bjhk,blhk->blh", w_intra, kc, qc)
        den_inter = w_inter * torch.einsum("bhk,blhk->blh", n, qc)
        den = torch.maximum(torch.abs(den_intra + den_inter),
                            torch.exp(-m_i))
        hs.append(num / den[..., None])

        # ---- carry update (chunk end) ------------------------------------
        bL = b[:, -1, :]                                       # (B,H)
        g_end = bL[:, None, :] - b + ic                        # (B,L,H)
        m_end = torch.maximum(bL + m, torch.amax(g_end, dim=1))
        w_end = torch.exp(g_end - m_end[:, None, :])
        decay = torch.exp(bL + m - m_end)
        C = decay[:, :, None, None] * C + \
            torch.einsum("blh,blhv,blhk->bhvk", w_end, vc, kc)
        n = decay[:, :, None] * n + torch.einsum("blh,blhk->bhk", w_end, kc)
        m = m_end

    h = torch.stack(hs, dim=1).reshape(B, S, H, dv)
    return h, (C, n, m)


def mlstm_block(p, x, cfg: ModelConfig, ax: MeshAxes, *,
                chunked: bool = True, chunk: int = 0):
    """Full mLSTM residual block body (pre-norm handled by caller)."""
    chunk = chunk or cfg.mlstm_chunk
    q, k, v = _mlstm_qkv(p, x, cfg, ax)
    it, ft = _mlstm_gates(p, x, ax)
    if chunked and x.shape[1] % min(chunk, x.shape[1]) == 0 \
            and x.shape[1] > 1:
        h, _ = mlstm_chunked(q, k, v, it, ft, chunk=min(chunk, x.shape[1]))
    else:
        h, _ = mlstm_scan_ref(q, k, v, it, ft)
    B, S = x.shape[:2]
    # output gate + down projection (row-parallel: inner dim is sharded)
    og = col_linear(x, p["w_og"], ax, fsdp_dim=0)
    h = h.reshape(B, S, -1).to(x.dtype) * torch.sigmoid(og.float()).to(
        x.dtype)
    return row_linear(h, p["w_down"], ax, fsdp_dim=1)


def mlstm_decode(p, x, state, cfg: ModelConfig, ax: MeshAxes):
    """One-token decode: state = (C, n, m)."""
    q, k, v = _mlstm_qkv(p, x, cfg, ax)
    it, ft = _mlstm_gates(p, x, ax)
    h, state = mlstm_scan_ref(q, k, v, it, ft, carry=state)
    B = x.shape[0]
    og = col_linear(x, p["w_og"], ax, fsdp_dim=0)
    h = h.reshape(B, 1, -1).to(x.dtype) * torch.sigmoid(og.float()).to(
        x.dtype)
    return row_linear(h, p["w_down"], ax, fsdp_dim=1), state


def mlstm_init_state(cfg: ModelConfig, B: int, ax: MeshAxes, device):
    H = cfg.n_heads
    inner = 2 * cfg.d_model
    dk = inner // H
    dv = (inner // ax.tp) // H
    return (torch.zeros((B, H, dv, dk), device=device),
            torch.zeros((B, H, dk), device=device),
            torch.full((B, H), -1e30, device=device))


# ===========================================================================
# sLSTM (diagonal-recurrence variant)
# ===========================================================================

def slstm_block(p, x, cfg: ModelConfig, ax: MeshAxes, *, state=None,
                return_state: bool = False):
    """Units TP-sharded; diagonal recurrent weights r_* (the reference's
    simplification of the paper's block-diagonal R)."""
    B, S, D = x.shape
    z = col_linear(x, p["w_z"], ax, fsdp_dim=0)      # (B,S,U_loc)
    i = col_linear(x, p["w_i"], ax, fsdp_dim=0)
    f = col_linear(x, p["w_f"], ax, fsdp_dim=0)
    o = col_linear(x, p["w_o"], ax, fsdp_dim=0)
    U = z.shape[-1]
    if state is None:
        dev = x.device
        c, n, h, m = (torch.zeros((B, U), device=dev),
                      torch.ones((B, U), device=dev),
                      torch.zeros((B, U), device=dev),
                      torch.zeros((B, U), device=dev))
    else:
        c, n, h, m = state

    ri, rf, rz, ro = (p["r_i"].float(), p["r_f"].float(), p["r_z"].float(),
                      p["r_o"].float())

    hs = []
    for t in range(S):
        zt, it, ft, ot = (a[:, t].float() for a in (z, i, f, o))
        it = it + ri * h
        ft = ft + rf * h
        zt = torch.tanh(zt + rz * h)
        ot = torch.sigmoid(ot + ro * h)
        logf = log_sigmoid(ft)
        m_new = torch.maximum(logf + m, it)
        ip = torch.exp(it - m_new)
        fp = torch.exp(logf + m - m_new)
        c = fp * c + ip * zt
        n = torch.maximum(fp * n + ip, torch.exp(-m_new))
        h = ot * (c / n)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)
    out = row_linear(y, p["w_down"], ax, fsdp_dim=1)
    if return_state:
        return out, (c, n, h, m)
    return out


def slstm_init_state(cfg: ModelConfig, B: int, ax: MeshAxes, device):
    U = cfg.d_model // ax.tp
    return (torch.zeros((B, U), device=device),
            torch.ones((B, U), device=device),
            torch.zeros((B, U), device=device),
            torch.zeros((B, U), device=device))


# ===========================================================================
# RG-LRU (Griffin / RecurrentGemma)
# ===========================================================================

C_RGLRU = 8.0


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def associative_scan(fn, elems, dim: int = 1):
    """Inclusive scan of the tuple ``elems`` along ``dim`` with the
    associative ``fn``, in log depth.  The recursion (combine adjacent
    pairs, scan the odd half, fill in the even half) is
    ``lax.associative_scan``'s, so the products are formed in its order."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.ndim
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    reduced = fn(tuple(sl(e, 0, -1, 2) for e in elems),
                 tuple(sl(e, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn(tuple(sl(e, 0, -1) for e in odd),
                  tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def _interleave(a, b, dim: int):
    """[a0, b0, a1, b1, ...] along ``dim`` (``len(a) - len(b)`` is 0 or 1)."""
    out_shape = list(a.shape)
    out_shape[dim] = a.shape[dim] + b.shape[dim]
    out = a.new_empty(out_shape)
    idx = [slice(None)] * a.ndim
    idx[dim] = slice(0, None, 2)
    out[tuple(idx)] = a
    idx[dim] = slice(1, None, 2)
    out[tuple(idx)] = b
    return out


def _rglru_core(x_in, gate_r, gate_i, lam, *, h0=None):
    """Elementwise gated linear recurrence via associative scan.
    x_in/gates: (B, S, W); lam: (W,) raw param.  Returns (B,S,W), h_last."""
    log_a0 = -C_RGLRU * softplus(lam.float())                      # (W,)
    r = torch.sigmoid(gate_r.float())
    i = torch.sigmoid(gate_i.float())
    log_a = log_a0[None, None, :] * r                               # (B,S,W)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                   min=1e-12)) * (i * x_in.float())

    if h0 is not None:
        # decode path: single step
        h = a[:, 0] * h0 + gated[:, 0]
        return h[:, None], h

    _, hh = associative_scan(_combine, (a, gated), dim=1)
    return hh, hh[:, -1]


def rglru_block(p, x, cfg: ModelConfig, ax: MeshAxes, *, state=None,
                return_state: bool = False):
    """Griffin recurrent block: in-proj (2 branches) -> conv1d -> RG-LRU ->
    gated multiply -> out-proj."""
    B, S, D = x.shape
    u = col_linear(x, p["w_in"], ax, fsdp_dim=0)     # (B,S,2*W_loc)
    w_loc = u.shape[-1] // 2
    branch, gate_branch = u[..., :w_loc], u[..., w_loc:]
    gate_branch = F.gelu(gate_branch.float(), approximate="tanh").to(x.dtype)

    # causal depthwise conv1d (width cfg.conv1d_width)
    cw = p["conv_w"].float()                         # (K, W_loc)
    K = cw.shape[0]
    if state is not None:
        seq = torch.cat([state["conv"], branch.float()], dim=1)
    else:
        seq = F.pad(branch.float(), (0, 0, K - 1, 0))
    new_conv_state = seq[:, -(K - 1):]
    conv = sum(seq[:, j:j + S] * cw[j][None, None, :] for j in range(K))
    conv = conv + p["conv_b"].float()

    gr = col_linear(x, p["w_a"], ax, fsdp_dim=0)     # recurrence gate
    gi = col_linear(x, p["w_x"], ax, fsdp_dim=0)     # input gate
    h0 = state["h"] if state is not None else None
    y, h_last = _rglru_core(conv, gr, gi, p["lam"], h0=h0)
    y = y.to(x.dtype) * gate_branch
    out = row_linear(y, p["w_out"], ax, fsdp_dim=1)
    if return_state:
        return out, {"h": h_last, "conv": new_conv_state}
    return out


def rglru_init_state(cfg: ModelConfig, B: int, ax: MeshAxes, device):
    W = (cfg.rglru_width or cfg.d_model) // ax.tp
    K = cfg.conv1d_width
    return {"h": torch.zeros((B, W), device=device),
            "conv": torch.zeros((B, K - 1, W), device=device)}
