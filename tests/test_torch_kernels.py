"""The port's masked arg-extremum against the JAX package's contract.

The plain PyTorch version (the CPU path of
``repro_torch.kernels.sched_ops``) must equal
``repro.kernels.ref.ref_masked_argext`` exactly — index and value — on
every case the JAX kernel is held to in ``tests/test_kernels.py``.  The
hand-written CUDA kernel is held against the plain version on the card
(marked ``cuda``; it skips without one).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import sched_ops  # noqa: E402

POS = 1e30


def _check(scores: np.ndarray, mask: np.ndarray, is_max: bool,
           msg: str = "") -> None:
    got_i, got_v = sched_ops.masked_argext(
        torch.from_numpy(scores), torch.from_numpy(mask), is_max=is_max)
    want_i, want_v = jref.ref_masked_argext(
        jnp.asarray(scores), jnp.asarray(mask), is_max=is_max)
    assert got_i.dtype == torch.int32 and got_v.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i),
                                  err_msg=msg)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v),
                                  err_msg=msg)


@pytest.mark.parametrize("is_max", [True, False])
@pytest.mark.parametrize("b,n", [(1, 32), (8, 64), (5, 200), (16, 128)])
def test_plain_argext_matches_jax_ref(b, n, is_max):
    rng = np.random.default_rng(hash((b, n, is_max)) % 2**31)
    scores = rng.normal(size=(b, n)).astype(np.float32)
    mask = rng.random((b, n)) < 0.4
    _check(scores, mask, is_max)


def test_plain_argext_property_random_masks():
    """Any (shape, scores, mask) agrees with the JAX reference, including
    all-False and all-True rows and tied scores."""
    try:
        import hypothesis as hyp
        from hypothesis import strategies as st
    except ImportError:  # container without the [test] extra: shim
        import _minihyp as hyp
        from _minihyp import strategies as st

    @hyp.settings(max_examples=40, deadline=None)
    @hyp.given(b=st.integers(1, 6), n=st.integers(1, 70),
               seed=st.integers(0, 2**31 - 1), is_max=st.booleans(),
               p=st.sampled_from([0.0, 0.15, 0.6, 1.0]),
               quantize=st.booleans())
    def run(b, n, seed, is_max, p, quantize):
        rng = np.random.default_rng(seed)
        scores = rng.normal(size=(b, n)).astype(np.float32)
        if quantize:                      # force ties
            scores = np.round(scores)
        _check(scores, rng.random((b, n)) < p, is_max)

    run()


def test_plain_argext_all_masked_rows_return_minus_one():
    scores = torch.arange(24, dtype=torch.float32).reshape(2, 12)
    mask = torch.zeros((2, 12), dtype=torch.bool)
    mask[1, 3] = True
    idx, val = sched_ops.masked_argext(scores, mask, is_max=True)
    assert idx.tolist() == [-1, 3]
    assert val.tolist() == [float(np.float32(-1e30)), 15.0]


def test_plain_argext_ties_break_to_first_index():
    mask = torch.ones((1, 5), dtype=torch.bool)
    idx, _ = sched_ops.masked_argmax(
        torch.tensor([[2.0, 5.0, 5.0, 1.0, 5.0]]), mask)
    assert int(idx[0]) == 1
    idx, _ = sched_ops.masked_argmin(
        torch.tensor([[3.0, 1.0, 4.0, 1.0, 9.0]]), mask)
    assert int(idx[0]) == 1


def test_plain_argext_masked_entry_wins_fill_tie():
    """An enabled score equal to the fill ties with the masked entries;
    the first index of the filled row wins, as ``argmax`` decides."""
    scores = np.asarray([[7.0, -1e30, 3.0]], np.float32)
    mask = np.asarray([[False, True, False]])
    _check(scores, mask, True)
    idx, _ = sched_ops.masked_argmax(torch.from_numpy(scores),
                                     torch.from_numpy(mask))
    assert int(idx[0]) == 0


def _fleet_hot_path_cases(rng):
    """Scores and masks shaped like the fleet tick's selection sites:
    ``steal_select`` (E, 64) rank scores with +1e12 steal-only offsets,
    ``export_select`` (E, 32) slacks with +POS empties, ``peer_offload``
    (1, E) loads with +POS invalid edges."""
    ranks = np.asarray([0.57, 0.43, 0.35, -0.012])   # Table-1 steal ranks
    for e in (1, 4, 8):
        score = ranks[rng.integers(0, 4, (e, 64))] \
            + np.where(rng.random((e, 64)) < 0.3, 1e12, 0.0)
        yield True, score.astype(np.float32), rng.random((e, 64)) < 0.5
        slack = rng.normal(0, 400.0, (e, 32))
        slack[rng.random((e, 32)) < 0.4] = POS       # empty queue slots
        yield False, slack.astype(np.float32), rng.random((e, 32)) < 0.3
    for e in (2, 3, 8):
        load = np.abs(rng.normal(500.0, 300.0, (1, e)))
        load[rng.random((1, e)) < 0.2] = POS         # padded edges
        yield False, load.astype(np.float32), np.ones((1, e), bool)


def test_plain_argext_on_fleet_hot_path_shapes():
    rng = np.random.default_rng(0xf1ee7)
    n_cases = 0
    for is_max, scores, mask in _fleet_hot_path_cases(rng):
        if n_cases == 0:
            mask = np.zeros_like(mask)               # all-ineligible row
        _check(scores, mask, is_max, f"case {n_cases}")
        n_cases += 1
    assert n_cases == 9


def test_plain_argext_nd_batch_shapes():
    scores = np.random.default_rng(0).normal(size=(3, 4, 40)).astype(
        np.float32)
    mask = np.random.default_rng(1).random((3, 4, 40)) < 0.5
    idx, _ = sched_ops.masked_argmin(torch.from_numpy(scores),
                                     torch.from_numpy(mask))
    assert idx.shape == (3, 4)
    _check(scores, mask, False)


def test_wrapper_takes_plain_path_only_on_cpu():
    """A CPU tensor runs the plain version and counts no launch; any
    other device goes to the hand kernel's checks, never the plain path."""
    before = sched_ops.launch_counts()
    s = torch.zeros(2, 8)
    m = torch.ones(2, 8, dtype=torch.bool)
    idx, _ = sched_ops.masked_argext(s, m, is_max=True)
    assert idx.tolist() == [0, 0]
    assert sched_ops.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        sched_ops.cuda_masked_argext(s, m, is_max=True)
    with pytest.raises(ValueError, match="CUDA"):
        sched_ops.masked_argext(s.to("meta"), m.to("meta"), is_max=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("is_max", [True, False])
def test_cuda_kernel_matches_plain(cuda_device, is_max):
    rng = np.random.default_rng(7)
    shapes = [(1, 64), (28, 64), (1024, 64), (28, 32), (1, 2), (1, 28),
              (1, 1024), (5, 1), (3, 2048), (9, 33)]
    for b, n in shapes:
        for quantize in (False, True):
            s = rng.normal(size=(b, n)).astype(np.float32)
            if quantize:
                s = np.round(s)
            m = rng.random((b, n)) < 0.5
            m[0] = False                                 # all-masked row
            st, mt = torch.from_numpy(s), torch.from_numpy(m)
            want_i, want_v = tref.ref_masked_argext(st, mt, is_max=is_max)
            got_i, got_v = sched_ops.masked_argext(
                st.to(cuda_device), mt.to(cuda_device), is_max=is_max)
            torch.cuda.synchronize()
            assert torch.equal(got_i.cpu(), want_i), (b, n)
            assert torch.equal(got_v.cpu(), want_v), (b, n)
