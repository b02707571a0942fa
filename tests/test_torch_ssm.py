"""The port's RMSNorm and selective-scan kernels' plain versions, and its
Mamba2 block, against the JAX package.

The same numpy inputs go through the JAX Pallas kernels in interpret mode
(``repro.kernels.ops``), the JAX oracles (``repro.kernels.ref``), the JAX
model layers (``repro.models.{layers,ssm}``) and the port's dispatch
(``repro_torch.kernels.ops``), which on CPU tensors runs the plain
PyTorch versions.  Tolerances are ``tests/test_kernels.py``'s: RMSNorm
1e-5 in float32 and 2e-2 in bfloat16, the scan 2e-4 (a sequential f32
recurrence against the chunked form sums in another order); the Mamba2
block 1e-4, the bar of ``tests/test_torch_models.py``.  The hand-written
CUDA kernels are held against the plain versions on the card (marked
``cuda``; they skip without one).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from repro_torch.kernels import ssm_scan as tscan  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else \
        dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(2, 128, 256), (4, 96, 512), (1, 1, 64),
                                   (300, 128), (3, 5, 1003)])
def test_plain_rmsnorm_matches_jax(shape, dtype):
    """``tests/test_kernels.py``'s shapes, and a D that is not a multiple
    of 8 (the kernel's scalar tail)."""
    rng = np.random.default_rng(sum(shape))
    jd, td = DTYPES[dtype]
    x = rng.standard_normal(shape, np.float32)
    scale = rng.standard_normal(shape[-1:], np.float32) + 1.0
    got = tops.rmsnorm(torch.from_numpy(x).to(td),
                       torch.from_numpy(scale).to(td))
    assert got.dtype == td and got.shape == shape
    xj, sj = jnp.asarray(x, jd), jnp.asarray(scale, jd)
    kernel = jops.rmsnorm(xj, sj, block_r=64)
    oracle = jref.ref_rmsnorm(xj, sj)
    np.testing.assert_allclose(_np(got), _np(kernel), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_routed_rms_norm_matches_jax_layer(impl):
    """The model's ``rms_norm`` on either route equals the JAX layer in
    f32 (the routes differ only in where bf16 would round)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 128), np.float32) * 3.0
    scale = rng.standard_normal(128, np.float32) * 0.5 + 1.5
    got = L.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5,
                     impl)
    want = JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# selective scan
# ---------------------------------------------------------------------------

def _scan_inputs(g, s, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((g, s, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((g, s), np.float32)))
    a = -np.exp(rng.standard_normal(g, np.float32) * 0.3)
    bm = rng.standard_normal((g, s, n), np.float32) * 0.3
    cm = rng.standard_normal((g, s, n), np.float32) * 0.3
    return [v.astype(np.float32) for v in (x, dt, a, bm, cm)]


@pytest.mark.parametrize("g,s,p,n,chunk", [
    (4, 256, 64, 64, 128),
    (2, 128, 32, 16, 64),
    (8, 512, 64, 64, 128),
])
def test_plain_selective_scan_matches_jax(g, s, p, n, chunk):
    args = _scan_inputs(g, s, p, n, g * s + p + n)
    got_y, got_f = tops.ssm_scan(*map(torch.from_numpy, args))
    assert got_y.shape == (g, s, p) and got_f.shape == (g, p, n)
    jargs = list(map(jnp.asarray, args))
    ker_y, ker_f = jops.ssm_scan(*jargs, chunk=chunk)
    ora_y, ora_f = jref.ref_selective_scan(*jargs)
    for got, want in ((got_y, ker_y), (got_f, ker_f), (got_y, ora_y),
                      (got_f, ora_f)):
        np.testing.assert_allclose(_np(got), _np(want), **SCAN_TOL)


def test_plain_selective_scan_state_carries_across_chunks():
    """Near-pure accumulation over 256 steps (``tests/test_kernels.py``'s
    carry case): the last y is ≈ s · dt · n, as the JAX kernel's is."""
    g, s, p, n = 1, 256, 8, 4
    x, dt = np.ones((g, s, p), np.float32), np.full((g, s), 1e-3, np.float32)
    a = np.full((g,), -0.01, np.float32)
    bm, cm = np.ones((g, s, n), np.float32), np.ones((g, s, n), np.float32)
    got, _ = tops.ssm_scan(*map(torch.from_numpy, (x, dt, a, bm, cm)))
    want, _ = jops.ssm_scan(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk=64)
    assert float(got[0, -1, 0]) > 0.9 * s * 0.001 * n
    np.testing.assert_allclose(_np(got), _np(want), **SCAN_TOL)


def _model_views(b, s, h, p, n, seed, device="cpu", dtype=torch.float32):
    """The model's (B,H) views of one input projection: xs and dt
    transposed, B/C shared by the heads through a zero head stride, the
    decay (f32) a stride-0 broadcast."""
    rng = np.random.default_rng(seed)
    di = h * p
    proj = torch.from_numpy(rng.standard_normal(
        (b, s, 2 * di + 2 * n + h), np.float32)).to(device, dtype)
    xs = proj[..., di:2 * di].reshape(b, s, h, p)
    bm = proj[..., 2 * di:2 * di + n] * 0.3
    cm = proj[..., 2 * di + n:2 * di + 2 * n] * 0.3
    dt = torch.nn.functional.softplus(proj[..., 2 * di + 2 * n:])
    a = -torch.exp(torch.from_numpy(rng.standard_normal(h, np.float32)))
    a = a.to(device)
    return (xs.transpose(1, 2), dt.transpose(1, 2), a.expand(b, h),
            bm[:, None].expand(b, h, s, n), cm[:, None].expand(b, h, s, n))


def test_scan_on_model_views_equals_contiguous_expansion():
    """(B,H)-shaped strided and broadcast views give what the contiguous
    (G,S,·) expansion gives, in the views' leading shape."""
    views = _model_views(2, 40, 3, 16, 8, 7)
    assert views[3].stride(1) == 0 and views[2].stride(0) == 0
    assert not views[0].is_contiguous()
    y, fin = tops.ssm_scan(*views)
    flat = [t.reshape(6, *t.shape[2:]).contiguous() for t in views]
    wy, wf = tops.ssm_scan(*flat)
    torch.testing.assert_close(y, wy.reshape(2, 3, 40, 16), rtol=0, atol=0)
    torch.testing.assert_close(fin, wf.reshape(2, 3, 16, 8), rtol=0, atol=0)


def test_empty_in_layout_follows_the_memory_order():
    """The wrapper's output for a transposed (B,H,S,P) view of a
    (B,S,H,P) buffer is a transposed view of a fresh (B,S,H,P) buffer, so
    the model's transpose back is contiguous."""
    x = torch.zeros(2, 5, 3, 4).transpose(1, 2)
    y = tscan.empty_in_layout(x)
    assert y.shape == x.shape and y.stride() == x.stride()
    assert y.transpose(1, 2).is_contiguous()
    c = torch.zeros(2, 3, 4)
    assert tscan.empty_in_layout(c).is_contiguous()


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

def _mamba(seq, seed=0):
    """(port cfg, JAX cfg, port params, JAX params, x) for one Mamba2 block
    of reduced zamba2-7b, its decay and D skip perturbed so they count."""
    cfg = reduced(ARCHS["zamba2-7b"])
    jcfg = JArchConfig(**convert.arch_to_fields(cfg))
    rng = np.random.default_rng(seed)
    tree = convert.random_numpy_params(cfg, seed)["mamba"]
    p = {k: v[0] for k, v in tree.items()}
    for name in ("dt_bias", "a_log", "d_skip"):
        p[name] = (p[name] + 0.3 * rng.standard_normal(
            p[name].shape, dtype=np.float32)).astype(np.float32)
    x = rng.standard_normal((2, seq, cfg.d_model), np.float32)
    return (cfg, jcfg, {k: torch.from_numpy(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()}, x)


@pytest.mark.parametrize("seq", [64, 256])
@pytest.mark.parametrize("route", ["chunked", "scan"])
def test_mamba_block_matches_jax(seq, route):
    """``ssd_chunked`` (plain) and ``ssd_scan`` (the kernel route: the
    selective scan from a zero state) against the JAX ``ssd_chunked``,
    within one chunk (S 64) and across a chunk boundary (S 256): output
    and final state."""
    cfg, jcfg, p, jp, x = _mamba(seq)
    fn = SSM.ssd_chunked if route == "chunked" else SSM.ssd_scan
    out, final = fn(p, cfg, torch.from_numpy(x))
    want_out, want_final = JSSM.ssd_chunked(jp, jcfg, jnp.asarray(x))
    assert out.shape == (2, seq, cfg.d_model)
    assert final.shape == (2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    np.testing.assert_allclose(_np(out), _np(want_out), **BLOCK_TOL)
    np.testing.assert_allclose(_np(final), _np(want_final), **BLOCK_TOL)


def test_ssd_chunked_carries_a_given_state():
    cfg, jcfg, p, jp, x = _mamba(128, seed=3)
    state = np.random.default_rng(4).standard_normal(
        (2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), np.float32)
    out, final = SSM.ssd_chunked(p, cfg, torch.from_numpy(x),
                                 torch.from_numpy(state))
    want_out, want_final = JSSM.ssd_chunked(jp, jcfg, jnp.asarray(x),
                                            jnp.asarray(state))
    np.testing.assert_allclose(_np(out), _np(want_out), **BLOCK_TOL)
    np.testing.assert_allclose(_np(final), _np(want_final), **BLOCK_TOL)


def test_ssd_decode_steps_match_jax_and_the_scan():
    """Four recurrent steps after a 60-token scan equal the JAX decode
    steps, and the scan over all 64 tokens."""
    cfg, jcfg, p, jp, x = _mamba(64, seed=5)
    _, state = SSM.ssd_scan(p, cfg, torch.from_numpy(x[:, :60]))
    _, jstate = JSSM.ssd_chunked(jp, jcfg, jnp.asarray(x[:, :60]))
    full, _ = SSM.ssd_scan(p, cfg, torch.from_numpy(x))
    for t in range(60, 64):
        out, state = SSM.ssd_decode_step(p, cfg,
                                         torch.from_numpy(x[:, t:t + 1]),
                                         state)
        want, jstate = JSSM.ssd_decode_step(jp, jcfg,
                                            jnp.asarray(x[:, t:t + 1]),
                                            jstate)
        np.testing.assert_allclose(_np(out), _np(want), **BLOCK_TOL)
        np.testing.assert_allclose(_np(state), _np(jstate), **BLOCK_TOL)
        np.testing.assert_allclose(_np(out), _np(full[:, t:t + 1]),
                                   **BLOCK_TOL)


def test_ssd_block_follows_the_route():
    cfg, _, p, _, x = _mamba(32)
    xt = torch.from_numpy(x)
    for impl, fn in (("ref", SSM.ssd_chunked), ("kernel", SSM.ssd_scan)):
        out, final = SSM.ssd_block(p, dataclasses.replace(
            cfg, attn_impl=impl), xt)
        want_out, want_final = fn(p, cfg, xt)
        torch.testing.assert_close(out, want_out, rtol=0, atol=0)
        torch.testing.assert_close(final, want_final, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_wrappers_take_plain_path_only_on_cpu():
    """A CPU tensor runs the plain version and counts no launch; any other
    device goes to the hand kernels' checks, never the plain path."""
    before = (trms.launch_count, tscan.launch_count)
    x = torch.ones(2, 8)
    args = [torch.ones(1, 4, 8), torch.ones(1, 4), torch.full((1,), -1.0),
            torch.ones(1, 4, 2), torch.ones(1, 4, 2)]
    tops.rmsnorm(x, torch.ones(8))
    tops.ssm_scan(*args)
    assert (trms.launch_count, tscan.launch_count) == before
    with pytest.raises(ValueError, match="CUDA"):
        trms.cuda_rmsnorm(x, torch.ones(8))
    with pytest.raises(ValueError, match="CUDA"):
        tops.rmsnorm(x.to("meta"), torch.ones(8, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tscan.cuda_ssm_scan(*args)
    with pytest.raises(ValueError, match="CUDA"):
        tops.ssm_scan(*(t.to("meta") for t in args))
    assert (trms.launch_count, tscan.launch_count) == before


def test_launch_counters_reset():
    trms.reset_count()
    tscan.reset_count()
    assert trms.launch_count == 0 and tscan.launch_count == 0


# ---------------------------------------------------------------------------
# the hand kernels on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_rmsnorm_matches_plain(cuda_device, dtype):
    td = DTYPES[dtype][1]
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    for shape in ((2, 128, 256), (300, 128), (64, 3584), (1, 3584),
                  (3, 5, 1003)):
        x = torch.randn(shape, generator=gen, device=cuda_device, dtype=td)
        scale = torch.randn(shape[-1:], generator=gen, device=cuda_device,
                            dtype=td) + 1.0
        torch.testing.assert_close(
            tops.rmsnorm(x, scale).float(),
            tref.ref_rmsnorm(x, scale).float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_ssm_scan_matches_plain(cuda_device, dtype):
    td = DTYPES[dtype][1]
    tol = SCAN_TOL if dtype == "float32" else _tol(dtype)
    for g, s, p, n in ((4, 256, 64, 64), (2, 128, 32, 16), (3, 37, 64, 64)):
        args = [torch.from_numpy(v).to(cuda_device)
                for v in _scan_inputs(g, s, p, n, g + s)]
        args = [t if i == 2 else t.to(td) for i, t in enumerate(args)]
        for got, want in zip(tops.ssm_scan(*args),
                             tref.ref_selective_scan(*args)):
            torch.testing.assert_close(got.float(), want.float(), **tol)
    views = _model_views(1, 64, 112, 64, 64, 1, cuda_device, td)
    assert views[3].stride(1) == 0 and views[4].stride(1) == 0
    for got, want in zip(tops.ssm_scan(*views),
                         tref.ref_selective_scan(*views)):
        torch.testing.assert_close(got.float(), want.float(), **tol)
