"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, strictly recurrent) — arXiv:2405.04517.

Port of ``repro.models.xlstm`` as plain tensor code (no kernel).  mLSTM
per head: C_t = f_t·C_{t−1} + i_t·(v_t k_tᵀ), n_t = f_t·n_{t−1} + i_t·k_t,
h_t = (C_t q_t) / max(|n_tᵀ q_t|, 1), run chunk-parallel; the scan over
chunks and sLSTM's recurrence over time are Python loops.  Where the JAX
code lets ``einsum`` promote a mixed f32 × bf16 product to f32, the port
casts the operands to f32 itself (``torch.einsum`` wants one dtype), and
a gate that scales a whole product is applied outside the ``einsum``
(the same sum, without the large intermediate a three-operand
contraction could build).

State caches: mLSTM (B, H, P, P) + (B, H, P); sLSTM (B, H, P) × 3.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

CHUNK = 256


def _heads(cfg: ArchConfig) -> tuple[int, int]:
    h = cfg.n_heads
    return h, cfg.d_inner // h        # (heads, per-head dim P)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_parallel(p: dict, cfg: ArchConfig, x: torch.Tensor,
                   state: tuple | None = None):
    """Full-sequence chunk-parallel mLSTM.  x: (B,S,D) → (B,S,D), with the
    final (C, n) state in ``x.dtype``."""
    b, s, d = x.shape
    h, pd = _heads(cfg)
    q = L.matmul(x, p["wq"]).reshape(b, s, h, pd)
    k = L.matmul(x, p["wk"]).reshape(b, s, h, pd) * pd ** -0.5
    v = L.matmul(x, p["wv"]).reshape(b, s, h, pd)
    gates = L.matmul(x, p["w_gate"])                 # (B,S,2H)
    logi, logf = gates.chunk(2, dim=-1)
    logf = L.shard_local(F.logsigmoid, logf.float())  # (B,S,H) ≤ 0
    logi = logi.float()

    nc = max(1, s // CHUNK)
    c = s // nc
    if nc * c != s:
        raise ValueError(f"mlstm_parallel: sequence length {s} does not "
                         f"split into {nc} equal chunks")
    qc = q.reshape(b, nc, c, h, pd)
    kc = k.reshape(b, nc, c, h, pd)
    vc = v.reshape(b, nc, c, h, pd)
    fi = logf.reshape(b, nc, c, h)
    ii = logi.reshape(b, nc, c, h)
    cumf = L.shard_local(functools.partial(torch.cumsum, dim=2), fi, 2)

    # intra-chunk: M[i,j] = exp(cumf_i − cumf_j + i_j) for j ≤ i
    expo = cumf[:, :, :, None, :] - cumf[:, :, None, :, :] + \
        ii[:, :, None, :, :]
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    m = torch.where(causal, torch.exp(expo.clamp(-60.0, 30.0)), 0.0)
    qk = L.einsum("bgihp,bgjhp->bgijh", qc, kc)
    w = (m * qk).to(x.dtype)                     # gated linear attention
    y_intra_v = L.einsum("bgijh,bgjhp->bgihp", w, vc)
    n_q = w.sum(dim=3)                           # q·(Σ_j M[i,j] k_j)

    # chunk summaries for the recurrence (f32, as JAX promotes them)
    tail = torch.exp((cumf[:, :, -1:, :] - cumf + ii).clamp(-60.0, 30.0))
    kf, vf = kc.float(), vc.float()
    c_sum = L.einsum("bgjhp,bgjhq->bghpq", tail[..., None] * vf, kf)
    n_sum = L.einsum("bgjh,bgjhp->bghp", tail, kf)
    cdec = torch.exp(cumf[:, :, -1, :].clamp(-60.0, 0.0))      # (B,nc,H)

    if state is None:
        cm = torch.zeros((b, h, pd, pd), dtype=torch.float32,
                         device=x.device)
        nm = torch.zeros((b, h, pd), dtype=torch.float32, device=x.device)
    else:
        cm, nm = state[0].float(), state[1].float()
    c_prev, n_prev = [], []
    for g in range(nc):                          # state at each chunk start
        c_prev.append(cm)
        n_prev.append(nm)
        cm = cm * cdec[:, g, :, None, None] + c_sum[:, g]
        nm = nm * cdec[:, g, :, None] + n_sum[:, g]
    c_prev = torch.stack(c_prev, 1).to(x.dtype).float()
    n_prev = torch.stack(n_prev, 1).to(x.dtype).float()

    into = torch.exp(cumf.clamp(-60.0, 0.0))     # decay chunk-start → i
    qf = qc.float()
    y_inter = into[..., None] * L.einsum("bghpq,bgihq->bgihp",
                                             c_prev, qf)
    n_inter = into * L.einsum("bghp,bgihp->bgih", n_prev, qf)

    num = (y_intra_v + y_inter).reshape(b, s, h, pd)
    den = (n_q + n_inter).reshape(b, s, h)
    y = num / den.abs().clamp(min=1.0)[..., None]
    out = L.matmul(y.to(x.dtype).reshape(b, s, cfg.d_inner), p["w_out"])
    return out, (cm.to(x.dtype), nm.to(x.dtype))


def mlstm_decode_step(p: dict, cfg: ArchConfig, x: torch.Tensor, state):
    """One-token mLSTM update.  x: (B,1,D)."""
    b = x.shape[0]
    h, pd = _heads(cfg)
    cm, nm = state
    q = (x @ p["wq"]).reshape(b, h, pd)
    k = (x @ p["wk"]).reshape(b, h, pd) * pd ** -0.5
    v = (x @ p["wv"]).reshape(b, h, pd)
    gates = (x @ p["w_gate"]).reshape(b, 2 * h)
    logi, logf = gates.chunk(2, dim=-1)
    f = torch.exp(L.shard_local(F.logsigmoid, logf.float()))
    i = torch.exp(logi.float().clamp(-60.0, 30.0))
    cm = cm * f[..., None, None] + i[..., None, None] * \
        L.einsum("bhp,bhq->bhpq", v, k)
    nm = nm * f[..., None] + i[..., None] * k
    qf = q.float()
    num = L.einsum("bhpq,bhq->bhp", cm, qf)
    den = L.einsum("bhp,bhp->bh", nm, qf)
    y = num / den.abs().clamp(min=1.0)[..., None]
    out = y.reshape(b, 1, cfg.d_inner).to(x.dtype) @ p["w_out"]
    return out, (cm.to(x.dtype), nm.to(x.dtype))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_cell(p, h_prev, c_prev, n_prev, xt):
    """One sLSTM step for all heads.  Shapes: (B, H, P)."""
    b, hh, pd = h_prev.shape
    inp = torch.cat([xt.reshape(b, hh, pd), h_prev], dim=-1)
    zifo = L.einsum("bhp,hpq->bhq", inp, p["w_rec"]) + p["b_rec"]
    z, i, f, o = zifo.chunk(4, dim=-1)              # (B,H,P) each
    z = torch.tanh(z)
    i = torch.exp(i.float().clamp(-60.0, 20.0))
    f = torch.exp(L.shard_local(F.logsigmoid, f.float()))
    o = torch.sigmoid(o)
    c = f * c_prev + i * z.float()
    n = f * n_prev + i
    h = o * (c / n.clamp(min=1.0)).to(o.dtype)
    return h, c, n


def slstm_scan(p: dict, cfg: ArchConfig, x: torch.Tensor,
               state: tuple | None = None):
    """Sequential sLSTM over the sequence.  x: (B,S,D) → (B,S,D)."""
    b, s, d = x.shape
    h, pd = cfg.n_heads, d // cfg.n_heads
    xt = L.matmul(x, p["w_in"])                      # (B,S,D)
    if state is None:
        hp = torch.zeros((b, h, pd), dtype=x.dtype, device=x.device)
        cp = torch.zeros((b, h, pd), dtype=torch.float32, device=x.device)
        np_ = torch.zeros((b, h, pd), dtype=torch.float32, device=x.device)
    else:
        hp, cp, np_ = state
    ys = []
    for t in range(s):
        hp, cp, np_ = _slstm_cell(p, hp, cp, np_, xt[:, t])
        ys.append(hp)
    y = torch.stack(ys, dim=1).reshape(b, s, d)
    return L.matmul(y, p["w_out"]), (hp, cp, np_)


def slstm_decode_step(p: dict, cfg: ArchConfig, x: torch.Tensor, state):
    b, _, d = x.shape
    xt = (x @ p["w_in"])[:, 0]
    hn, cn, nn = _slstm_cell(p, *state, xt)
    return hn.reshape(b, 1, d) @ p["w_out"], (hn, cn, nn)
