"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``):
run the same numpy signals through the JAX fleet and the CPU port and
compare final states leaf by leaf."""
import jax
import numpy as np

from repro.sim import fleet_jax as FJ
from repro_torch import convert
from repro_torch.sim import fleet as F

# integer and boolean leaves must be equal; float leaves are held to this
# tolerance, though the port keeps the reference's operation order and
# exact equality is the expected outcome
RTOL, ATOL = 1e-6, 1e-4


def leaves(tree, prefix=""):
    if isinstance(tree, tuple):
        for name, val in zip(tree._fields, tree):
            yield from leaves(val, f"{prefix}{name}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def assert_states_match(got, want) -> None:
    """``got``: the port's final state (tensors); ``want``: the JAX one."""
    got = convert.to_numpy(got)
    want = jax.tree.map(np.asarray, want)
    names = []
    for (name, g), (_, w) in zip(leaves(got), leaves(want)):
        names.append(name)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if w.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert len(names) == len(list(leaves(want)))


def assert_signals_equal(got, want) -> None:
    """``got``: port ``FleetSignals`` (tensors); ``want``: the JAX ones."""
    assert got._fields == tuple(want._fields)
    for name, g, w in zip(got._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert g.tobytes() == w.tobytes(), name


def run_pair(models, policy, signals, *, cloud_slots=FJ.CLOUD_SLOTS):
    """(port final state on the CPU, JAX final state) on the same
    signals, handed to the port through numpy."""
    want = FJ.run_fleet(models, policy, signals, cloud_slots=cloud_slots)
    sig = convert.from_numpy(F.FleetSignals,
                             jax.tree.map(np.asarray, signals), "cpu")
    got = F.run_fleet(models, policy, sig, cloud_slots=cloud_slots,
                      device="cpu")
    return got, want


def port_signals(signals, device="cpu"):
    """JAX ``FleetSignals`` (any leading axes) as the port's, via numpy."""
    return convert.from_numpy(F.FleetSignals,
                              jax.tree.map(np.asarray, signals), device)


def assert_hist_adjacent(got, want, name="") -> None:
    """Histograms ``[..., B]`` with equal totals per cell whose
    differences are moves to an adjacent bin only (the earth mover's
    distance of each cell equals half its L1 difference)."""
    d = got.astype(np.int64) - want.astype(np.int64)
    assert (d.sum(-1) == 0).all(), name
    emd = np.abs(np.cumsum(d, -1)).sum(-1)
    assert (2 * emd == np.abs(d).sum(-1)).all(), name


def assert_counters_match(got, want, *, hist_adjacent=False) -> None:
    """``TickCounters`` leaf by leaf: integer and boolean leaves exactly,
    f32 leaves to RTOL/ATOL; with ``hist_adjacent`` the histograms may
    differ by adjacent-bin moves (XLA's fused multiply-add under factors
    other than 1.0)."""
    got = convert.to_numpy(got)
    for name, g, w in zip(want._fields, got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (
            name, g.dtype, w.dtype, g.shape, w.shape)
        if w.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        elif hist_adjacent and name.endswith("_hist"):
            assert_hist_adjacent(g, w, name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
