"""The redesigned RMSNorm and masked arg-extremum bodies, on the CPU.

RMSNorm: :func:`repro_torch.kernels.rmsnorm.norm_plan`, the pure function
that sizes the register-resident body's launch, at every shape the
served paths hand it and over every width; views off the 16-byte width
go to the previous body.  Masked arg-extremum:
:func:`repro_torch.kernels.ref.ref_packed_argext`, the emulation of the
packed-key body's arithmetic, against the port's plain version and the
JAX package's reference.  Both hand-written bodies against their plain
versions on the card (marked ``cuda``; they skip without one).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.kernels import sched_ops as SO  # noqa: E402

BF, F32 = torch.bfloat16, torch.float32
# (rows, D) of the served paths: zamba2 decode, serve, prefill; granite
# serve, decode, prefill (B 2 × 512, B 8 × 512); starcoder2 serve;
# nemotron-4-340b serve and decode
PATH_SHAPES = [(1, 3584), (64, 3584), (128, 3584), (64, 2048), (8, 2048),
               (1024, 2048), (4096, 2048), (64, 3072), (64, 18432),
               (1, 18432)]
RMS_TOL = {F32: 1e-5, BF: 2e-2}


def _check_regs_plan(plan, rows, d, dtype):
    """A REGS plan covers the row's vectors exactly: every warp holds a
    vector in the first pass and the last pass holds one (in the
    many-row layout, whose ``vpt`` is a power of two, half as many
    vectors would not cover the row), the block is whole row groups
    within 1024 threads, and the row data fits the register budget at
    that block size."""
    route, vpt, k, rpb, threads = plan
    vec = RN.VEC_BYTES // torch.tensor([], dtype=dtype).element_size()
    nvec = d // vec
    assert route == RN.REGS and nvec * vec == d
    assert (vpt, k) in RN.PLANS[dtype]
    assert threads == 32 * k * rpb <= 1024
    assert rpb == 1 if k > 1 else 1 <= rpb <= RN.ROWS_PER_BLOCK
    assert 32 * k * vpt >= nvec
    assert 32 * (k - 1) < nvec
    assert (RN.row_registers(vpt, dtype) + RN.REG_OVERHEAD
            <= RN.register_cap(threads))
    if rows >= RN.MANY_ROWS and nvec <= 256:
        assert k == 1 and rpb == RN.ROWS_PER_BLOCK
        assert vpt & (vpt - 1) == 0 and 32 * (vpt // 2) < nvec
    else:
        assert 32 * k * (vpt - 1) < nvec


@pytest.mark.parametrize("dtype", [BF, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("rows,d", PATH_SHAPES + [(0, 3584), (300, 128),
                                                  (300, 3584), (1, 64)])
def test_norm_plan_at_path_shapes(rows, d, dtype):
    plan = RN.norm_plan(rows, d, dtype, True)
    _check_regs_plan(plan, rows, d, dtype)
    assert RN.norm_plan(rows, d, dtype, True) == plan         # pure
    assert RN.norm_plan(rows, d, dtype, False)[0] == RN.PREVIOUS


def test_norm_plan_layouts_of_serve_prefill_and_nemotron():
    """The serve shape takes one row group of 8 warps × 2 vectors, a
    prefill a warp a row × 8 vectors, four rows a block, and nemotron's
    D 18432 in bf16 1024 threads × 3 vectors."""
    assert RN.norm_plan(64, 3584, BF, True) == (RN.REGS, 2, 8, 1, 256)
    assert RN.norm_plan(4096, 2048, BF, True) == (RN.REGS, 8, 1, 4, 128)
    assert RN.norm_plan(1024, 2048, BF, True) == (RN.REGS, 8, 1, 4, 128)
    assert RN.norm_plan(64, 18432, BF, True) == (RN.REGS, 3, 32, 1, 1024)
    assert RN.norm_plan(1, 18432, F32, True) == (RN.REGS, 5, 32, 1, 1024)


@pytest.mark.parametrize("dtype", [BF, F32], ids=["bf16", "f32"])
def test_norm_plan_over_every_width(dtype):
    """Every D on the vector width up to the register plan's widest row
    takes REGS with a plan the C side is built for; one vector more takes
    PREVIOUS, and so does every D off the width."""
    vec = 8 if dtype == BF else 4
    widest = (3 if dtype == BF else 5) * 1024 * vec
    for rows in (1, 255, 256):
        for d in range(vec, widest + 1, vec):
            _check_regs_plan(RN.norm_plan(rows, d, dtype, True), rows, d,
                             dtype)
        assert RN.norm_plan(rows, widest + vec, dtype, True)[0] \
            == RN.PREVIOUS
        for d in (1, vec - 1, vec + 1, 1003, 3585):
            assert RN.norm_plan(rows, d, dtype, True)[0] == RN.PREVIOUS


@pytest.mark.parametrize("dtype", [BF, F32], ids=["bf16", "f32"])
def test_view_plan_routes_views(dtype):
    """Views the wrapper hands on as they are: a strided 2-D view on the
    width takes REGS; a row stride off it, x's or scale's base one
    element in, or D off the vector takes PREVIOUS.  A view whose rows cannot be merged is
    copied first, and the copy is on the width."""
    scale = torch.ones(3584, dtype=dtype)
    on = torch.zeros(64, 3600, dtype=dtype)[:, :3584]
    assert RN.view_plan(on, scale)[0] == RN.REGS
    assert RN.view_plan(torch.zeros(4, 65, 3584, dtype=dtype)[:, 1:],
                        scale)[0] == RN.REGS
    off_stride = torch.zeros(64, 3585, dtype=dtype)[:, :3584]
    assert RN.view_plan(off_stride, scale)[0] == RN.PREVIOUS
    off_base = torch.zeros(2, 64, 3585, dtype=dtype)[..., 1:]
    assert RN.view_plan(off_base, scale)[0] == RN.PREVIOUS
    assert RN.view_plan(torch.zeros(3, 5, 1003, dtype=dtype),
                        torch.ones(1003, dtype=dtype))[0] == RN.PREVIOUS
    off_scale = torch.ones(3585, dtype=dtype)[1:]          # scale's base
    assert RN.view_plan(on, off_scale)[0] == RN.PREVIOUS
    one_row = torch.zeros(2, 3600, dtype=dtype)[1:, 16:]   # 32 B in
    assert RN.view_plan(one_row, torch.ones(3584, dtype=dtype))[0] \
        == RN.REGS


# ---------------------------------------------------------------------------
# the packed-key arithmetic
# ---------------------------------------------------------------------------

def _cases(rows, n, is_max, seed):
    """Scores and masks with every trap of the key: ties rounded from
    normals, -0.0 beside +0.0, ±inf, enabled scores equal to the fill,
    all-masked rows, masks of every density."""
    rng = np.random.default_rng(seed)
    fill = SO.NEG if is_max else SO.POS
    s = rng.normal(size=(rows, n))
    s[rows // 2:] = np.round(s[rows // 2:])                 # ties
    zero = rng.random((rows, n)) < 0.3                      # ±0.0 ties
    s[zero] = np.where(rng.random(zero.sum()) < 0.5, -0.0, 0.0)
    s[rng.random((rows, n)) < 0.05] = np.inf
    s[rng.random((rows, n)) < 0.05] = -np.inf
    s[rng.random((rows, n)) < 0.1] = fill
    dens = rng.choice([0.0, 0.05, 0.5, 1.0], size=(rows, 1))
    m = rng.random((rows, n)) < dens
    s[0] = -0.0                                  # one row of ±0.0 ties
    s[0, n // 2:] = 0.0
    m[0] = True
    if rows > 1:
        s[1] = fill                              # enabled fills only
        m[1, ::2] = True
    if rows > 2:
        m[2] = False                             # all masked
    return s.astype(np.float32), m


def _same_values(got: torch.Tensor, want: torch.Tensor) -> None:
    """Equal as numbers (+0.0 == -0.0), and bit for bit wherever not
    zero."""
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    nz = want != 0
    np.testing.assert_array_equal(got[nz].view(torch.int32).numpy(),
                                  want[nz].view(torch.int32).numpy())


@pytest.mark.parametrize("is_max", [True, False], ids=["max", "min"])
@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 64, 200])
@pytest.mark.parametrize("rows", [1, 3, 28, 1024])
def test_packed_argext_matches_refs(rows, n, is_max):
    """The packed-key emulation's index equals the port's plain version's
    and the JAX reference's, and its value theirs (:func:`_same_values`:
    a tie of -0.0 and +0.0 keeps the first one's sign in the key body,
    while a reduction's max may return either)."""
    s, m = _cases(rows, n, is_max, seed=rows * 1000 + n * 2 + is_max)
    st, mt = torch.from_numpy(s), torch.from_numpy(m)
    got_i, got_v = tref.ref_packed_argext(st, mt, is_max=is_max)
    want_i, want_v = tref.ref_masked_argext(st, mt, is_max=is_max)
    j_i, j_v = jref.ref_masked_argext(jnp.asarray(s), jnp.asarray(m),
                                      is_max=is_max)
    assert got_i.dtype == torch.int32 and got_v.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), want_i.numpy())
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(j_i))
    _same_values(got_v, want_v)
    _same_values(got_v, torch.from_numpy(np.array(j_v)))


def test_packed_key_orders_values_then_first_index():
    """The key's order is the value's (±0.0 equal, ±inf at the ends) and,
    between equal values, the lower index's; complemented for min."""
    vals = [-np.inf, -1e30, -1.5, -0.0, 0.0, 1e-45, 2.0, 1e30, np.inf]
    s = torch.tensor([vals], dtype=torch.float32)
    m = torch.ones_like(s, dtype=torch.bool)
    for is_max, want in ((True, len(vals) - 1), (False, 0)):
        idx, val = tref.ref_packed_argext(s, m, is_max=is_max)
        assert int(idx) == want and float(val) == vals[want]
    z = torch.tensor([[1.0, -0.0, 0.0, -0.0]])
    idx, val = tref.ref_packed_argext(z, torch.ones_like(z, dtype=torch.bool),
                                      is_max=False)
    assert int(idx) == 1 and str(float(val)) == "-0.0"


# ---------------------------------------------------------------------------
# the hand-written bodies on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sdtype", [BF, F32], ids=["scale-bf16",
                                                   "scale-f32"])
@pytest.mark.parametrize("dtype", [BF, F32], ids=["bf16", "f32"])
def test_cuda_rmsnorm_bodies_match_plain(cuda_device, dtype, sdtype):
    """Each body on the path shapes and on views off the width: the one
    :func:`view_plan` names within the tolerance of the plain version,
    and the previous one where the new one took the view."""
    gen = torch.Generator(device=cuda_device).manual_seed(20)
    tol = RMS_TOL[dtype]
    views = [torch.randn(s, generator=gen, device=cuda_device).to(dtype)
             for s in PATH_SHAPES + [(300, 128), (3, 5, 1003)]]
    views.append(torch.randn(64, 3600, generator=gen,
                             device=cuda_device).to(dtype)[:, :3584])
    views.append(torch.randn(2, 64, 3585, generator=gen,
                             device=cuda_device).to(dtype)[..., 1:])
    for x in views:
        d = x.shape[-1]
        scale = (torch.randn(d, generator=gen, device=cuda_device)
                 + 1.0).to(sdtype)
        want = tref.ref_rmsnorm(x, scale).float()
        routes = [None] + ([RN.PREVIOUS] if RN.view_plan(x, scale)[0]
                           == RN.REGS else [])
        for route in routes:
            n0 = RN.reg_launch_count
            got = RN.cuda_rmsnorm(x, scale, _route=route).float()
            torch.cuda.synchronize()
            assert RN.reg_launch_count - n0 == (
                route is None and RN.view_plan(x, scale)[0] == RN.REGS)
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("is_max", [True, False], ids=["max", "min"])
def test_cuda_argext_bodies_match_plain(cuda_device, is_max):
    """Both bodies equal the plain version, index exactly and value by
    :func:`_same_values`, on the packed key's traps at every N up to beyond the 64-entry
    chunk, and on rows one entry off the float2 alignment."""
    for rows in (1, 3, 28, 1024):
        for n in (1, 2, 31, 32, 33, 63, 64, 65, 200, 2048):
            s, m = _cases(rows, n, is_max, seed=rows + n)
            st, mt = torch.from_numpy(s), torch.from_numpy(m)
            want_i, want_v = tref.ref_masked_argext(st, mt, is_max=is_max)
            for route in (SO.KEY, SO.PREVIOUS):
                got_i, got_v = SO.cuda_masked_argext(
                    st.to(cuda_device), mt.to(cuda_device), is_max=is_max,
                    _route=route)
                torch.cuda.synchronize()
                assert torch.equal(got_i.cpu(), want_i), (rows, n, route)
                _same_values(got_v.cpu(), want_v)
                if route == SO.KEY:          # its emulation, sign and all
                    emu_i, emu_v = tref.ref_packed_argext(st, mt,
                                                          is_max=is_max)
                    assert torch.equal(got_i.cpu(), emu_i)
                    assert torch.equal(got_v.cpu().view(torch.int32),
                                       emu_v.view(torch.int32))
    s, m = _cases(4, 64, is_max, seed=9)         # bases one element in
    st = torch.zeros(4 * 64 + 1, device=cuda_device)
    mt = torch.zeros(4 * 64 + 1, dtype=torch.bool, device=cuda_device)
    st[1:] = torch.from_numpy(s).reshape(-1).to(cuda_device)
    mt[1:] = torch.from_numpy(m).reshape(-1).to(cuda_device)
    st, mt = st[1:].view(4, 64), mt[1:].view(4, 64)
    got = SO.cuda_masked_argext(st, mt, is_max=is_max)
    want = tref.ref_masked_argext(st.cpu(), mt.cpu(), is_max=is_max)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
