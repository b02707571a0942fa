"""The selective scan's chunked (SSD) body: its plain emulation against the
sequential scan and the JAX package, and the rule that routes a call to it.

``repro_torch.kernels.ref.ref_chunked_scan`` repeats the arithmetic of the
tensor-core body of ``csrc/ssm_scan.cu`` (chunks of 64 steps, the bf16
hi + lo splits of its f32 operands) in plain PyTorch.  The same numpy
inputs go through it, the port's sequential ``ref_selective_scan`` and
the JAX Pallas kernel in interpret mode (``repro.kernels.ops.ssm_scan``,
at tiny shapes).  Tolerances: f32 2e-4, ``tests/test_kernels.py``'s bar
for a scan that sums in another order; bf16 2e-2 + 2e-2·|want| against
the f32 scan of the same bf16 inputs, the kernels' bf16 bar.  Every input
comes from a fixed seed.  The kernel itself runs only on the card (marked
``cuda``; it skips without one).
"""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssm_scan as tscan  # noqa: E402

SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = 2e-2


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


def _inputs(g, s, p, n, seed):
    """f32 numpy inputs: decays in (−e^0.9, −e^−0.9), softplus steps."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((g, s, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((g, s), np.float32)))
    a = -np.exp(rng.standard_normal(g, np.float32) * 0.3)
    bm = rng.standard_normal((g, s, n), np.float32) * 0.3
    cm = rng.standard_normal((g, s, n), np.float32) * 0.3
    return [v.astype(np.float32) for v in (x, dt, a, bm, cm)]


def _views(s, seed, b=1, h=112, p=64, n=64, dtype=torch.bfloat16):
    """The model's (B,H) views of one input projection (``chip_smoke.py``'s
    ``scan_views`` recipe, from a numpy seed): x and dt transposed, B/C
    shared by the heads through a zero head stride, the f32 decay a
    stride-0 broadcast."""
    rng = np.random.default_rng(seed)
    di = h * p
    proj = torch.from_numpy(rng.standard_normal(
        (b, s, 2 * di + 2 * n + h), np.float32)).to(dtype)
    xs = proj[..., di:2 * di].reshape(b, s, h, p)
    bm = proj[..., 2 * di:2 * di + n]
    cm = proj[..., 2 * di + n:2 * di + 2 * n]
    dt = torch.nn.functional.softplus(proj[..., 2 * di + 2 * n:])
    a = -torch.exp(torch.from_numpy(rng.standard_normal(h, np.float32))
                   * 0.3)
    return (xs.transpose(1, 2), dt.transpose(1, 2), a.expand(b, h),
            bm[:, None].expand(b, h, s, n), cm[:, None].expand(b, h, s, n))


# ---------------------------------------------------------------------------
# the emulation in f32: within a chunk, across chunks, ragged chunks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,s,p,n", [
    (2, 37, 48, 20),      # one ragged chunk, N off the 16-column tile
    (2, 64, 64, 64),      # the serve path's S: exactly one chunk
    (2, 70, 48, 16),      # a full chunk and a ragged one of 6 steps
    (1, 128, 64, 64),     # two chunks
    (1, 256, 48, 64),     # four chunks: the state carried three times
])
def test_chunked_emulation_matches_sequential_scan(g, s, p, n):
    args = _inputs(g, s, p, n, seed=g * s + p + n)
    got_y, got_f = tref.ref_chunked_scan(*map(torch.from_numpy, args))
    assert got_y.shape == (g, s, p) and got_f.shape == (g, p, n)
    want_y, want_f = tref.ref_selective_scan(*map(torch.from_numpy, args))
    np.testing.assert_allclose(_np(got_y), _np(want_y), **SCAN_TOL)
    np.testing.assert_allclose(_np(got_f), _np(want_f), **SCAN_TOL)


@pytest.mark.parametrize("g,s,p,n,chunk", [
    (1, 37, 8, 20, 37),
    (1, 70, 8, 16, 70),
    (1, 256, 8, 16, 128),
])
def test_chunked_emulation_matches_jax_kernel(g, s, p, n, chunk):
    """Against the Pallas kernel in interpret mode, at tiny P: one ragged
    chunk of the emulation (S 37), one and a ragged one (S 70), and four
    against the JAX kernel's two (S 256)."""
    args = _inputs(g, s, p, n, seed=s + n)
    got_y, got_f = tref.ref_chunked_scan(*map(torch.from_numpy, args))
    ker_y, ker_f = jops.ssm_scan(*map(jnp.asarray, args), chunk=chunk)
    np.testing.assert_allclose(_np(got_y), _np(ker_y), **SCAN_TOL)
    np.testing.assert_allclose(_np(got_f), _np(ker_f), **SCAN_TOL)


def test_chunked_emulation_carries_the_state():
    """Near-pure accumulation over 256 steps (four chunks;
    ``tests/test_kernels.py``'s carry case): the last y is ≈ s · dt · n,
    as the sequential scan's and the JAX kernel's are."""
    g, s, p, n = 1, 256, 8, 4
    x, dt = np.ones((g, s, p), np.float32), np.full((g, s), 1e-3, np.float32)
    a = np.full((g,), -0.01, np.float32)
    bm, cm = np.ones((g, s, n), np.float32), np.ones((g, s, n), np.float32)
    args = (x, dt, a, bm, cm)
    got, fin = tref.ref_chunked_scan(*map(torch.from_numpy, args))
    assert float(got[0, -1, 0]) > 0.9 * s * 1e-3 * n
    want, want_f = jops.ssm_scan(*map(jnp.asarray, args), chunk=64)
    np.testing.assert_allclose(_np(got), _np(want), **SCAN_TOL)
    np.testing.assert_allclose(_np(fin), _np(want_f), **SCAN_TOL)
    seq, _ = tref.ref_selective_scan(*map(torch.from_numpy, args))
    np.testing.assert_allclose(_np(got), _np(seq), **SCAN_TOL)


# ---------------------------------------------------------------------------
# the emulation in bf16 on the zamba2 path's views
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [64, 128])
def test_chunked_emulation_bf16_zamba2_views_within_tolerance(s):
    """B 1, H 112, P = N = 64 in bf16: every y and final-state entry
    within 2e-2 + 2e-2·|want| of the f32 sequential scan of the same bf16
    values (one chunk at S 64; the carried state at S 128)."""
    views = _views(s, seed=64)
    assert views[3].stride(1) == 0 and views[4].stride(1) == 0
    got_y, got_f = tref.ref_chunked_scan(*views)
    assert got_y.dtype == torch.bfloat16 and got_y.shape == (1, 112, s, 64)
    assert got_f.shape == (1, 112, 64, 64)
    want_y, want_f = tref.ref_selective_scan(*(v.float() for v in views))
    for got, want in ((got_y, want_y), (got_f, want_f)):
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), want, rtol=BF16_TOL,
                                   atol=BF16_TOL)


def test_chunked_emulation_zero_head_stride_equals_expansion():
    """B/C shared by the heads through a zero head stride (and the decay a
    broadcast) give what their contiguous (G,S,·) expansion gives."""
    views = _views(40, seed=7, b=2, h=3, p=16, n=8, dtype=torch.float32)
    assert views[3].stride(1) == 0 and views[4].stride(1) == 0
    y, fin = tref.ref_chunked_scan(*views)
    flat = [t.reshape(6, *t.shape[2:]).contiguous() for t in views]
    wy, wf = tref.ref_chunked_scan(*flat)
    torch.testing.assert_close(y, wy.reshape(2, 3, 40, 16), rtol=0, atol=0)
    torch.testing.assert_close(fin, wf.reshape(2, 3, 16, 8), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------

def _route_of(x, bm, cm):
    return tscan.scan_route(x, bm, cm)


def test_route_float32_takes_the_sequential_body():
    x, bm, cm = torch.zeros(2, 64, 64), torch.zeros(2, 64, 64), \
        torch.zeros(2, 64, 64)
    assert _route_of(x, bm, cm) == tscan.SEQ
    views = _views(64, seed=1, h=4, dtype=torch.float32)
    assert _route_of(views[0], views[3], views[4]) == tscan.SEQ


def test_route_bf16_aligned_views_take_the_chunked_body():
    """The model's views (transposed x, B/C at a zero head stride) lie on
    the 16-byte width: 16-byte copies.  So do contiguous (G,S,·) inputs."""
    views = _views(64, seed=1, h=112)
    assert _route_of(views[0], views[3], views[4]) == tscan.CHUNKED
    bf = dict(dtype=torch.bfloat16)
    assert _route_of(torch.zeros(3, 37, 48, **bf), torch.zeros(3, 37, 16,
                                                                **bf),
                     torch.zeros(3, 37, 16, **bf)) == tscan.CHUNKED
    x = torch.zeros(1, 4, 8, 128, **bf)
    assert _route_of(x, torch.zeros(1, 4, 8, 128, **bf),
                     torch.zeros(1, 4, 8, 128, **bf)) == tscan.CHUNKED


@pytest.mark.parametrize("what", ["p", "n", "offset", "stride"])
def test_route_bf16_off_the_16_byte_width_takes_the_sequential_body(what):
    """P or N off a multiple of 8, a base address off 16 bytes, or an S
    stride off 8 elements: the chunked body copies 16-byte rows, so such
    bf16 views take the sequential body."""
    bf = dict(dtype=torch.bfloat16)
    x, bm, cm = (torch.zeros(2, 64, 64, **bf) for _ in range(3))
    if what == "p":
        x = torch.zeros(2, 64, 60, **bf)
    elif what == "n":
        bm, cm = torch.zeros(2, 64, 20, **bf), torch.zeros(2, 64, 20, **bf)
    elif what == "offset":
        x = torch.zeros(2, 64, 65, **bf)[..., 1:]
    else:
        bm = torch.zeros(2, 64, 68, **bf)[..., :64]
    assert _route_of(x, bm, cm) == tscan.SEQ


def test_route_ignores_strides_of_length_one_axes():
    """An axis of length one is only read at index 0: its stride does not
    decide the loads."""
    bf = dict(dtype=torch.bfloat16)
    buf = torch.zeros(1, 64, 3 * 64, **bf)
    x = buf[:, :, :64]                      # S stride 192: on the width
    assert x.stride(0) == 64 * 192
    assert _route_of(x, buf[:, :, 64:128], buf[:, :, 128:]) == tscan.CHUNKED
    one = torch.zeros(1, 1, 64, **bf)
    odd = one.as_strided((1, 1, 64), (3, 5, 1))
    assert _route_of(odd, one, one) == tscan.CHUNKED


@pytest.mark.parametrize("layout", ["model", "contiguous", "head0"])
def test_chunked_output_lies_on_the_16_byte_width(layout):
    """The chunked body stores y in 16-byte rows: wherever the rule takes
    it, the y that the wrapper allocates has a contiguous P axis and
    (b, h, s) strides on 8 elements.  That holds for an x read through a
    zero head stride too, whose y keeps P innermost."""
    bf = dict(dtype=torch.bfloat16)
    views = _views(64, seed=2, h=8)         # a projection row of 1160
    x, bm, cm = views[0], views[3], views[4]
    if layout == "contiguous":
        x = x.contiguous()
    elif layout == "head0":
        x = x[:, :1].expand(x.shape)
    assert _route_of(x, bm, cm) == tscan.CHUNKED
    y = tscan.empty_in_layout(x)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert y.stride(-1) == 1
    assert all(st % 8 == 0 for st in y.stride()[:-1])
    assert y.is_contiguous() == (layout == "contiguous")
    assert torch.zeros(1, **bf).data_ptr() % 16 == 0


def test_route_counter_counts_the_chunked_launches():
    """Each launch adds one to ``launch_count``; the chunked route also to
    ``tc_launch_count``; ``reset_count`` zeroes both."""
    tscan.reset_count()
    for route in (tscan.SEQ, tscan.CHUNKED, tscan.SEQ, tscan.CHUNKED):
        tscan._counted(route)
    assert (tscan.launch_count, tscan.tc_launch_count) == (4, 2)
    tscan.reset_count()
    assert (tscan.launch_count, tscan.tc_launch_count) == (0, 0)


def test_cpu_dispatch_runs_the_sequential_plain_version():
    """On CPU tensors the dispatch takes the plain sequential scan, never
    the emulation, and counts no launch."""
    views = _views(64, seed=3, h=4)
    tscan.reset_count()
    y, fin = tops.ssm_scan(*views)
    wy, wf = tref.ref_selective_scan(*views)
    torch.testing.assert_close(y, wy, rtol=0, atol=0)
    torch.testing.assert_close(fin, wf, rtol=0, atol=0)
    assert (tscan.launch_count, tscan.tc_launch_count) == (0, 0)


def test_scan_source_rebuilds_on_the_tensor_core_header(tmp_path,
                                                       monkeypatch):
    """The chunked body takes its ``cp.async``, ``ldmatrix`` and
    ``mma.sync`` helpers from ``tc_bf16.cuh``: an edit to the header
    changes the scan library's build key."""
    for f in ("ssm_scan.cu", "tc_bf16.cuh"):
        shutil.copy(_build.CSRC / f, tmp_path / f)
    assert '#include "tc_bf16.cuh"' in (tmp_path / "ssm_scan.cu").read_text()
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._target(tscan.KERNEL)[1]
    with open(tmp_path / "tc_bf16.cuh", "a") as fh:
        fh.write("// edited\n")
    assert _build._target(tscan.KERNEL)[1] != before


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s", [37, 64, 100, 512])
def test_cuda_chunked_body_matches_plain_and_previous(cuda_device, s):
    """The chunked body on the zamba2 views against the plain scan, its
    emulation and the previous (sequential) body, each within the bf16
    bar; every launch but the forced one counted on the tensor cores."""
    views = [t.to(cuda_device) for t in _views(s, seed=s)]
    assert tscan.scan_route(views[0], views[3], views[4]) == tscan.CHUNKED
    tscan.reset_count()
    got = tscan.cuda_ssm_scan(*views)
    prev = tscan.cuda_ssm_scan(*views, _route=tscan.SEQ)
    assert (tscan.launch_count, tscan.tc_launch_count) == (2, 1)
    want = tref.ref_selective_scan(*views)
    emu = tref.ref_chunked_scan(*views)
    for g_, p_, w_, e_ in zip(got, prev, want, emu):
        for other in (w_, p_, e_):
            torch.testing.assert_close(g_.float(), other.float(),
                                       rtol=BF16_TOL, atol=BF16_TOL)
