"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Each function here is the semantics its hand-written kernel reproduces:
bit for bit for the selection kernel, and up to the order of its f32
sums for the attention, RMSNorm, selective-scan and grouped-GEMM kernels
(the last on rows that some expert owns: see :func:`ref_moe_gemm`).  The CPU
path runs these; on the card they are the yardstick the kernels are
compared with.  :func:`ref_chunked_scan` is of another kind: it repeats
the arithmetic of the scan kernel's chunked bf16 body, rounding points
included, so that the CPU tests can hold that arithmetic to the scan's
tolerance; no path runs it.
"""
from __future__ import annotations

import torch

NEG = -1e30
POS = 1e30


def ref_masked_argext(scores: torch.Tensor, mask: torch.Tensor, *,
                      is_max: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked first-occurrence arg-extremum over the last axis.

    Disabled entries are filled with ∓1e30, ``idx`` (int32) is the first
    index attaining the extremum of the *filled* row (so a masked entry
    can win a tie with an enabled ∓1e30 score, as ``argmax`` on the
    filled row does), and a row with no enabled entry yields ``idx == -1``
    with the fill value.  NaN scores are outside the contract.
    """
    fill = NEG if is_max else POS
    v = torch.where(mask, scores.float(), fill)
    idx = (torch.argmax(v, -1) if is_max else torch.argmin(v, -1)).int()
    some = torch.broadcast_to(mask, v.shape).any(-1)
    val = v.amax(-1) if is_max else v.amin(-1)
    return torch.where(some, idx, -1), val


def ref_packed_argext(scores: torch.Tensor, mask: torch.Tensor, *,
                      is_max: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ref_masked_argext` by the arithmetic of the ``KEY`` body of
    ``csrc/masked_argext.cu``, for the tests and ``chip_smoke.py`` only:
    each filled entry j becomes one 64-bit key, its value mapped to an
    order-preserving u32 (-0.0 first mapped to +0.0; complemented for
    min) in the high half and ``0xFFFFFFFF - j`` in the low half; the
    largest key wins, and the value is the winner's filled score as read,
    never decoded from the key.  Keys are held as int64 with the high
    half offset by 2**31, which keeps their order."""
    fill = NEG if is_max else POS
    v = torch.where(mask, scores.float(), fill)
    n = v.shape[-1]
    u = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, 0, u)
    u = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    if not is_max:
        u = u ^ 0xFFFFFFFF
    low = 0xFFFFFFFF - torch.arange(n, dtype=torch.int64, device=v.device)
    key = ((u - 2**31) << 32) | low
    j = 0xFFFFFFFF - (key.amax(-1) & 0xFFFFFFFF)
    val = torch.gather(v, -1, j[..., None])[..., 0]
    some = torch.broadcast_to(mask, v.shape).any(-1)
    return torch.where(some, j, -1).int(), val


def _repeat_heads(x: torch.Tensor, groups: int) -> torch.Tensor:
    """``jnp.repeat(x, groups, axis=1)``: KV heads → query heads."""
    return x.repeat_interleave(groups, dim=1) if groups > 1 else x


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,H,S,hd); k/v: (B,KV,S,hd) → (B,H,S,hd).  GQA via repeat.

    Logits in f32, masked entries filled with -1e30, and the softmax cast
    back to ``q.dtype`` before the product with ``v``.
    """
    s, hd = q.shape[2], q.shape[3]
    groups = q.shape[1] // k.shape[1]
    k = _repeat_heads(k, groups)
    v = _repeat_heads(v, groups)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float()
    logits = logits * hd ** -0.5
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def ref_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q: (B,H,hd); k/v: (B,KV,W,hd); lengths: (B,) valid prefix →
    (B,H,hd)."""
    hd = q.shape[-1]
    groups = q.shape[1] // k.shape[1]
    k = _repeat_heads(k, groups)
    v = _repeat_heads(v, groups)
    logits = torch.einsum("bhd,bhkd->bhk", q, k).float()
    logits = logits * hd ** -0.5
    valid = (torch.arange(k.shape[2], device=q.device)[None, :]
             < lengths.to(q.device)[:, None])
    logits = torch.where(valid[:, None, :], logits, NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhk,bhkd->bhd", probs, v)


def ref_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """x (..., D), scale (D,): variance in f32, ``x·rsqrt(var+eps)·scale``
    in f32, cast to ``x.dtype`` once at the end (the fused kernel's order;
    the model's plain ``rms_norm`` casts the rsqrt first)."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def ref_selective_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       bmat: torch.Tensor, cmat: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential SSD recurrence (the Mamba2 core), from a zero state.

    x (*L,S,P); dt (*L,S); a (*L); bmat/cmat (*L,S,N), where the leading
    shape L is (G,) with G = batch × heads, or (B, H):
      state_t = exp(a·dt_t)·state_{t−1} + dt_t·(x_t ⊗ B_t)
      y_t     = state_t · C_t
    in f32.  Returns (y (*L,S,P), final state (*L,P,N)) in ``x.dtype``.
    """
    lead, (s, p) = x.shape[:-2], x.shape[-2:]
    n = bmat.shape[-1]
    xf = x.reshape(-1, s, p).float()
    dtf = dt.reshape(-1, s).float()
    af = a.reshape(-1).float()
    bf = bmat.reshape(-1, s, n).float()
    cf = cmat.reshape(-1, s, n).float()
    state = torch.zeros((xf.shape[0], p, n), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(s):
        dec = torch.exp(af * dtf[:, t])
        state = state * dec[:, None, None] + dtf[:, t, None, None] * (
            xf[:, t, :, None] * bf[:, t, None, :])
        ys.append(torch.einsum("gpn,gn->gp", state, cf[:, t]))
    y = torch.stack(ys, 1) if ys else xf.new_zeros((xf.shape[0], 0, p))
    return (y.reshape(*lead, s, p).to(x.dtype),
            state.reshape(*lead, p, n).to(x.dtype))


SCAN_CHUNK = 64          # the chunked scan body's chunk length (kQ)


def _bf16_split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``v`` (f32) as the bf16 pair hi = bf16(v), lo = bf16(v − hi), both
    returned in f32."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both f32 operands split into bf16 hi + lo and the three
    leading products summed in f32: hi·hi + lo·hi + hi·lo."""
    ah, al = _bf16_split(a)
    bh, bl = _bf16_split(b)
    return al @ bh + ah @ bl + ah @ bh


def _split_lhs_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with the f32 ``a`` split into bf16 hi + lo and ``b`` taken as
    given (exact in bf16 on the kernel's path): hi·b + lo·b."""
    ah, al = _bf16_split(a)
    return al @ b + ah @ b


def ref_chunked_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     bmat: torch.Tensor, cmat: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked (SSD) body of the scan kernel (``csrc/ssm_scan.cu``,
    routes 1 and 2) in plain PyTorch: :func:`ref_selective_scan`'s
    arguments and results, computed as the kernel computes them — chunks
    of ``SCAN_CHUNK`` steps; in each, cum_t = Σ_{s≤t} a·dt_s (f32),
    G = C·Bᵀ on the inputs as given, M = G ∘ exp(cum_t − cum_s) ∘ dt_s
    for s ≤ t, y = M·x + (C ∘ exp(cum_t))·S_prevᵀ, and the state
    S = exp(cum_last)·S_prev + (x ∘ w)ᵀ·B with w_s = exp(cum_last −
    cum_s)·dt_s, carried in f32.  Every f32 operand of a product is split
    into bf16 hi + lo (M, x ∘ w, C ∘ exp(cum_t), S_prev); x and B are
    taken as given (exact in bf16 on the kernel's path).  y and the final
    state are rounded once to ``x.dtype``.  Only the tests and
    ``chip_smoke.py`` call it: it shows the rounding points keep the
    kernel's arithmetic within the scan's tolerance."""
    lead, (s, p) = x.shape[:-2], x.shape[-2:]
    n = bmat.shape[-1]
    xf = x.reshape(-1, s, p).float()
    dtf = dt.reshape(-1, s).float()
    af = a.reshape(-1).float()
    bf = bmat.reshape(-1, s, n).float()
    cf = cmat.reshape(-1, s, n).float()
    state = torch.zeros((xf.shape[0], p, n), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t0 in range(0, s, SCAN_CHUNK):
        xc, dc = xf[:, t0:t0 + SCAN_CHUNK], dtf[:, t0:t0 + SCAN_CHUNK]
        bc, cc = bf[:, t0:t0 + SCAN_CHUNK], cf[:, t0:t0 + SCAN_CHUNK]
        q = xc.shape[1]
        cum = torch.cumsum(af[:, None] * dc, dim=1)              # (G, q)
        last = cum[:, -1:]
        causal = torch.ones(q, q, dtype=torch.bool,
                            device=x.device).tril()
        diff = torch.where(causal, cum[:, :, None] - cum[:, None, :], 0.0)
        m = torch.where(causal, (cc @ bc.transpose(1, 2)) * dc[:, None, :]
                        * torch.exp(diff), 0.0)
        y = _split_lhs_matmul(m, xc)
        if t0 > 0:
            y = y + _split_matmul(cc * torch.exp(cum)[..., None],
                                  state.transpose(1, 2))
        ys.append(y)
        w = torch.exp(last - cum) * dc
        state = state * torch.exp(last)[..., None] + _split_lhs_matmul(
            (xc * w[..., None]).transpose(1, 2), bc)
    y = torch.cat(ys, 1) if ys else xf.new_zeros((xf.shape[0], 0, p))
    return (y.reshape(*lead, s, p).to(x.dtype),
            state.reshape(*lead, p, n).to(x.dtype))


def ref_moe_gemm(x_sorted: torch.Tensor, w: torch.Tensor,
                 offsets: torch.Tensor) -> torch.Tensor:
    """Ragged grouped GEMM oracle.

    x_sorted: (T,D) rows sorted by expert; w: (E,D,F); offsets: (E+1,) —
    expert e owns rows [offsets[e], offsets[e+1]).  Each row is multiplied
    by its expert's weights.  A row before ``offsets[0]`` or from
    ``offsets[E]`` on is clipped to expert 0 or E−1 here, where the kernel
    (like the JAX package's ``_moe_kernel``) writes zeros: the two agree
    where ``offsets[0] == 0`` and ``offsets[E] == T``, as on the model's
    path.
    """
    t = x_sorted.shape[0]
    e = w.shape[0]
    rows = torch.arange(t, device=x_sorted.device)
    expert_of = (rows[:, None] >= offsets.to(x_sorted.device)[None, 1:]
                 ).sum(1)
    expert_of = expert_of.clamp(0, e - 1)
    return torch.einsum("td,tdf->tf", x_sorted, w[expert_of])
