"""The port's attention kernels' plain versions against the JAX package.

The same numpy inputs go through the JAX Pallas kernels in interpret mode
(``repro.kernels.ops``, at the block sizes ``tests/test_kernels.py``
uses), the JAX oracles (``repro.kernels.ref``) and the port's dispatch
(``repro_torch.kernels.ops``), which on CPU tensors runs the plain
PyTorch versions.  Tolerances are ``tests/test_kernels.py``'s: 1e-5 in
float32, 2e-2 in bfloat16 (the two frameworks round bf16 products at
other places).  The hand-written CUDA kernels are held against the plain
versions on the card (marked ``cuda``; they skip without one).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else \
        dict(rtol=1e-5, atol=1e-5)


def _pair(arr, name):
    """The same values as a JAX array and a torch tensor (bf16 rounding
    from float32 is round-to-nearest-even in both)."""
    jd, td = DTYPES[name]
    return jnp.asarray(arr, jd), torch.from_numpy(arr).to(td)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,kv,s,hd", [
    (1, 4, 4, 128, 64),      # MHA
    (2, 8, 2, 256, 64),      # GQA 4:1
    (1, 4, 1, 128, 128),     # MQA
    (1, 4, 4, 128, 112),     # zamba2's head dim
    (1, 12, 1, 128, 192),    # nemotron-4-340b's head dim, a group of 12
])
@pytest.mark.parametrize("window", [0, 64])
def test_plain_flash_matches_jax(b, h, kv, s, hd, dtype, window):
    rng = np.random.default_rng(hash((b, h, s, window)) % 2**31)
    qj, qt = _pair(rng.standard_normal((b, h, s, hd), np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((b, kv, s, hd), np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((b, kv, s, hd), np.float32), dtype)
    got = tops.flash_attention(qt, kt, vt, causal=True, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    kernel = jops.flash_attention(qj, kj, vj, causal=True, window=window,
                                  block_q=64, block_k=64)
    oracle = jref.ref_attention(qj, kj, vj, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(kernel), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))


def test_plain_flash_non_causal_matches_jax():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 2, 128, 64), np.float32)
               for _ in range(3))
    got = tops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=False)
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=False,
                                block_q=64, block_k=64)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [1, 17, 64])
def test_plain_flash_on_serve_path_shapes(s):
    """The serve path's shapes (one sequence, S ≤ 128, block = S as the
    JAX ``attend_pallas`` picks it): granite's GQA 32/8 at hd 64, a
    starcoder2-like 12:1 group at hd 128 and zamba2's shared block (32/32
    heads at hd 112), causal with a 16-key band."""
    rng = np.random.default_rng(s)
    for h, kv, hd in ((32, 8, 64), (24, 2, 128), (32, 32, 112)):
        q = rng.standard_normal((1, h, s, hd), np.float32)
        k = rng.standard_normal((1, kv, s, hd), np.float32)
        v = rng.standard_normal((1, kv, s, hd), np.float32)
        for window in (0, 16):
            got = tops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                       causal=True, window=window)
            want = jops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                        causal=True, window=window,
                                        block_q=s, block_k=s)
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                       atol=1e-5)


def test_plain_flash_takes_transposed_views():
    """The model hands the kernel (B,S,H,hd) activations as transposed
    views; the result keeps the query's layout."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 16, 4, 64), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 16, 2, 64), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 16, 2, 64), np.float32))
    got = tops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2))
    want = tref.ref_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,kv,w,hd", [
    (2, 4, 4, 512, 64),
    (3, 8, 2, 1024, 64),
    (1, 4, 1, 256, 128),
    (2, 4, 4, 256, 112),
    (2, 12, 1, 256, 192),    # nemotron-4-340b's head dim, a group of 12
])
def test_plain_decode_matches_jax(b, h, kv, w, hd, dtype):
    rng = np.random.default_rng(hash((b, h, w)) % 2**31)
    qj, qt = _pair(rng.standard_normal((b, h, hd), np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((b, kv, w, hd), np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((b, kv, w, hd), np.float32), dtype)
    lengths = rng.integers(1, w + 1, (b,)).astype(np.int32)
    got = tops.decode_attention(qt, kt, vt, torch.from_numpy(lengths))
    assert got.dtype == qt.dtype and got.shape == qt.shape
    kernel = jops.decode_attention(qj, kj, vj, jnp.asarray(lengths),
                                   block_s=128)
    oracle = jref.ref_decode_attention(qj, kj, vj, jnp.asarray(lengths))
    np.testing.assert_allclose(_np(got), _np(kernel), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))


@pytest.mark.parametrize("length", [1, 2, 255, 256])
def test_plain_decode_on_strided_cache_view(length):
    """The model's cache is (B,W,KV,hd); decode reads it through a
    transposed (B,KV,W,hd) view — equal to the JAX kernel on the same
    values laid out contiguously, for lengths from 1 to W."""
    rng = np.random.default_rng(length)
    b, w, kv, h, hd = 2, 256, 2, 8, 64
    cache_k = rng.standard_normal((b, w, kv, hd), np.float32)
    cache_v = rng.standard_normal((b, w, kv, hd), np.float32)
    q = rng.standard_normal((b, h, hd), np.float32)
    lengths = np.full((b,), length, np.int32)
    kt = torch.from_numpy(cache_k).transpose(1, 2)
    vt = torch.from_numpy(cache_v).transpose(1, 2)
    assert not kt.is_contiguous()
    got = tops.decode_attention(torch.from_numpy(q), kt, vt,
                                torch.from_numpy(lengths))
    want = jops.decode_attention(
        jnp.asarray(q), jnp.asarray(cache_k.transpose(0, 2, 1, 3)),
        jnp.asarray(cache_v.transpose(0, 2, 1, 3)), jnp.asarray(lengths),
        block_s=128)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_decode_hd192_semantics(dtype):
    """nemotron-4-340b's decode shape at reduced width (hd 192, a group
    of 12 query heads a KV head) on the model's transposed cache views:
    the plain version equals the JAX Pallas kernel (interpret mode) and
    oracle at lengths 1, off the 128-row block and W, and rows at or
    past a batch row's length never reach its output."""
    rng = np.random.default_rng(192)
    b, w, kv, h, hd = 3, 256, 2, 24, 192
    ck = rng.standard_normal((b, w, kv, hd), np.float32)
    cv = rng.standard_normal((b, w, kv, hd), np.float32)
    q = rng.standard_normal((b, h, hd), np.float32)
    lengths = np.asarray([1, 131, w], np.int32)
    qj, qt = _pair(q, dtype)
    kj, kt = _pair(np.ascontiguousarray(ck.transpose(0, 2, 1, 3)), dtype)
    vj, vt = _pair(np.ascontiguousarray(cv.transpose(0, 2, 1, 3)), dtype)
    views = tuple(torch.from_numpy(c).to(DTYPES[dtype][1]).transpose(1, 2)
                  for c in (ck, cv))
    got = tops.decode_attention(qt, *views, torch.from_numpy(lengths))
    kernel = jops.decode_attention(qj, kj, vj, jnp.asarray(lengths),
                                   block_s=128)
    oracle = jref.ref_decode_attention(qj, kj, vj, jnp.asarray(lengths))
    np.testing.assert_allclose(_np(got), _np(kernel), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))
    ck2, cv2 = ck.copy(), cv.copy()
    for i, n in enumerate(lengths):
        ck2[i, n:] = 1e4
        cv2[i, n:] = -1e4
    views2 = tuple(torch.from_numpy(c).to(DTYPES[dtype][1]).transpose(1, 2)
                   for c in (ck2, cv2))
    torch.testing.assert_close(
        tops.decode_attention(qt, *views2, torch.from_numpy(lengths)), got,
        rtol=0, atol=0)


@pytest.mark.parametrize("w", [1, 63, 64, 65, 160, 576, 1024, 4096, 500_000])
@pytest.mark.parametrize("b,kv", [(1, 1), (1, 8), (8, 2), (8, 8), (64, 8),
                                  (1, 32)])
def test_decode_split_plan(w, b, kv):
    """The split kernel's plan: slices of whole 64-row units that cover
    W, at most ``MAX_SPLITS`` of them and as small as the target of two
    (batch row, KV head, slice) blocks an SM asks for.  It is a function
    of W, B and KV (and the card's SM count) alone, so it never waits on
    the values in ``lengths``."""
    import inspect
    assert list(inspect.signature(tdecode.plan_splits).parameters) == [
        "w", "b", "kv", "sms"]
    splits, chunk = tdecode.plan_splits(w, b, kv)
    assert chunk % tdecode.BLOCK_ROWS == 0 and chunk > 0
    assert 1 <= splits <= tdecode.MAX_SPLITS
    assert splits * chunk >= w > (splits - 1) * chunk
    units = -(-w // tdecode.BLOCK_ROWS)
    want = min(units, tdecode.MAX_SPLITS,
               -(-2 * tdecode.H100_SMS // (b * kv)))
    assert splits <= want and chunk // tdecode.BLOCK_ROWS == -(-units // want)
    assert tdecode.plan_splits(w, b, kv) == (splits, chunk)
    assert tdecode.plan_splits(w, b, kv, sms=66)[0] <= splits


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_wrappers_take_plain_path_only_on_cpu():
    """A CPU tensor runs the plain version and counts no launch; any
    other device goes to the hand kernels' checks, never the plain path."""
    before = (tflash.launch_count, tdecode.launch_count)
    q = torch.zeros(1, 2, 4, 64)
    k = torch.zeros(1, 1, 4, 64)
    tops.flash_attention(q, k, k)
    tops.decode_attention(q[:, :, 0], k, k, torch.ones(1, dtype=torch.int32))
    assert (tflash.launch_count, tdecode.launch_count) == before
    with pytest.raises(ValueError, match="CUDA"):
        tflash.cuda_flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tdecode.cuda_decode_attention(q[:, :, 0], k, k,
                                      torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        tops.decode_attention(q[:, :, 0].to("meta"), k.to("meta"),
                              k.to("meta"), torch.ones(1, device="meta"))


def test_launch_counters_reset():
    tflash.reset_count()
    tdecode.reset_count()
    assert tflash.launch_count == 0 and tdecode.launch_count == 0


# ---------------------------------------------------------------------------
# the route a launch takes (CUDA cores for f32, tensor cores for bf16)
# ---------------------------------------------------------------------------

def _qkv(dtype, b=2, h=8, kv=2, s=24, hd=64, layout="bshd"):
    """q, k, v as the model hands them over: (B,S,H,hd) activations seen
    through transposed views, or contiguous (B,H,S,hd) tensors."""
    if layout == "bshd":
        return tuple(torch.zeros(b, s, n, hd, dtype=dtype).transpose(1, 2)
                     for n in (h, kv, kv))
    return tuple(torch.zeros(b, n, s, hd, dtype=dtype) for n in (h, kv, kv))


@pytest.mark.parametrize("hd", tflash.HEAD_DIMS)
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_route_bf16_takes_tensor_cores(hd, layout):
    q, k, v = _qkv(torch.bfloat16, hd=hd, layout=layout)
    assert tflash.tc_route(q, k, v) == tflash.TC


@pytest.mark.parametrize("hd", tflash.HEAD_DIMS)
def test_flash_route_f32_takes_cuda_cores(hd):
    q, k, v = _qkv(torch.float32, hd=hd)
    assert tflash.tc_route(q, k, v) == tflash.CORE
    # f32 never needs the 16-byte rows, so an odd view is taken as it is
    odd = torch.zeros(1, 2, 4, 68)[..., 1:65]
    assert tflash.tc_route(odd, odd, odd) == tflash.CORE


@pytest.mark.parametrize("which", ["q", "k", "v"])
@pytest.mark.parametrize("view", ["offset", "s_stride", "h_stride"])
def test_flash_route_misaligned_bf16_view_raises(which, view):
    """A bf16 view whose rows are not 16-byte aligned (a storage offset
    or a (b, h, s) stride off a multiple of 8 elements) no longer
    raises: it takes the CUDA-core body, which reads elements."""
    bad = {"offset": torch.zeros(2, 8, 24, 72, dtype=torch.bfloat16)
           [..., 4:68],
           "s_stride": torch.zeros(2, 8, 24, 68, dtype=torch.bfloat16)
           [..., :64],
           "h_stride": torch.zeros(2 * 8 * 1540, dtype=torch.bfloat16)
           .as_strided((2, 8, 24, 64), (8 * 1540, 1540, 64, 1))}[view]
    q, k, v = _qkv(torch.bfloat16, h=8, kv=8)
    args = dict(q=q, k=k, v=v)
    args[which] = bad
    assert tflash.tc_route(args["q"], args["k"], args["v"]) == tflash.CORE


def test_flash_route_ignores_strides_of_unit_axes():
    """An axis of length one is only read at index 0, so its stride does
    not decide the route (B 1 and MQA's single KV head)."""
    q = torch.zeros(1, 4, 24, 64, dtype=torch.bfloat16).as_strided(
        (1, 4, 24, 64), (3, 24 * 64, 64, 1))
    k = torch.zeros(1, 1, 24, 64, dtype=torch.bfloat16).as_strided(
        (1, 1, 24, 64), (5, 7, 64, 1))
    assert tflash.tc_route(q, k, k) == tflash.TC


@pytest.mark.parametrize("arch,d_model,hd", [
    ("granite-3-2b", 256, 64),
    ("starcoder2-3b", 512, 128),
    ("zamba2-7b", 448, 112),
])
def test_flash_route_of_the_model_views(monkeypatch, arch, d_model, hd):
    """The views a bf16 forward under ``"kernel"`` hands
    ``ops.flash_attention`` (reduced depth, published head dim) take the
    tensor-core route; the same model in f32 takes the CUDA cores."""
    import dataclasses
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.model import Model
    routes = []
    real = tops.flash_attention

    def spy(q, k, v, **kw):
        routes.append((q.dtype, tflash.tc_route(q, k, v)))
        return real(q, k, v, **kw)
    monkeypatch.setattr(tops, "flash_attention", spy)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (2, 24))).long()
    for dtype, want in (("bfloat16", tflash.TC), ("float32", tflash.CORE)):
        cfg = dataclasses.replace(reduced(ARCHS[arch], d_model=d_model),
                                  attn_impl="kernel", dtype=dtype,
                                  param_dtype=dtype)
        assert cfg.head_dim == hd
        model = Model(cfg, "cpu")
        routes.clear()
        model.forward(model.init(torch.Generator().manual_seed(0)),
                      {"tokens": tokens})
        assert routes and routes == [(getattr(torch, dtype), want)] * len(
            routes)


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
def test_cuda_flash_matches_plain(cuda_device, dtype):
    td = DTYPES[dtype][1]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for b, h, kv, s, hd in ((1, 4, 4, 128, 64), (2, 8, 2, 256, 64),
                            (1, 4, 1, 128, 128), (1, 32, 8, 17, 64),
                            (1, 24, 2, 64, 128), (1, 32, 32, 64, 112),
                            (2, 8, 2, 100, 112), (1, 32, 8, 64, 64),
                            (8, 32, 8, 512, 64), (2, 8, 1, 203, 128),
                            (1, 96, 8, 64, 192), (2, 8, 2, 100, 192)):
        # contiguous (B,H,S,hd), and the model's (B,S,H,hd) views
        dense = tuple(torch.randn(shape, generator=gen, device=cuda_device,
                                  dtype=td)
                      for shape in ((b, h, s, hd), (b, kv, s, hd),
                                    (b, kv, s, hd)))
        views = tuple(t.transpose(1, 2).contiguous().transpose(1, 2)
                      for t in dense)
        # rows off the 16-byte width: the CUDA-core body in either dtype
        wide = torch.randn((b, s, h + 2 * kv, hd + 1), generator=gen,
                           device=cuda_device, dtype=td)
        odd = (wide[:, :, :h, 1:].transpose(1, 2),
               wide[:, :, h:h + kv, :hd].transpose(1, 2),
               wide[:, :, h + kv:, 1:].transpose(1, 2))
        for q, k, v in (dense, views, odd):
            for causal, window in ((True, 0), (True, 64), (False, 0)):
                _check_cuda_flash(q, k, v, causal, window, dtype)


def _check_cuda_flash(q, k, v, causal, window, dtype):
    want = tref.ref_attention(q, k, v, causal=causal, window=window)
    before = tflash.tc_launch_count
    got = tops.flash_attention(q, k, v, causal=causal, window=window)
    assert tflash.tc_launch_count - before == (
        tflash.tc_route(q, k, v) == tflash.TC)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    if dtype == "bfloat16":             # the previous CUDA-core body
        got = tflash.cuda_flash_attention(q, k, v, causal=causal,
                                          window=window, _route=tflash.CORE)
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_decode_matches_plain(cuda_device, dtype):
    td = DTYPES[dtype][1]
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    for b, w, kv, h, hd in ((3, 1024, 2, 8, 128), (2, 512, 32, 32, 112),
                            (2, 300, 8, 96, 192), (1, 200, 1, 40, 64)):
        _check_cuda_decode(cuda_device, gen, td, dtype, b, w, kv, h, hd)


def _check_cuda_decode(cuda_device, gen, td, dtype, b, w, kv, h, hd):
    """The split kernel on the model's cache views and on views off the
    16-byte width, the previous body on the aligned ones; a batch row of
    length 0 gives zeros (the plain version averages V there)."""
    cache_k = torch.randn((b, w, kv, hd), generator=gen, device=cuda_device,
                          dtype=td)
    cache_v = torch.randn((b, w, kv, hd), generator=gen, device=cuda_device,
                          dtype=td)
    wide = torch.randn((b, w, kv, hd + 1), generator=gen, device=cuda_device,
                       dtype=td)
    q = torch.randn((b, h, hd), generator=gen, device=cuda_device, dtype=td)
    for aligned, kc, vc in ((True, cache_k, cache_v),
                            (False, wide[..., :hd], wide[..., 1:])):
        kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
        for length in (0, 1, 31, 32, 33, 65, w // 2 - 12, w):
            lengths = torch.full((b,), length, dtype=torch.int32,
                                 device=cuda_device)
            lengths[-1] = min(length + 7, w)
            want = tref.ref_decode_attention(q, kt, vt, lengths)
            got = tops.decode_attention(q, kt, vt, lengths)
            runs = [got]
            if aligned:
                runs.append(tdecode.cuda_decode_attention(
                    q, kt, vt, lengths, _route=tdecode.PREVIOUS))
            for got in runs:
                empty = lengths == 0
                assert not bool(got[empty].any())
                torch.testing.assert_close(got[~empty].float(),
                                           want[~empty].float(),
                                           **_tol(dtype))
