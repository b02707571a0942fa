"""Set-up's wait for the card's slow mode, on readings given to it."""
import pytest

from portbench.harness import settle


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _wait(readings, cap_s=settle.CAP_S):
    clock = _Clock()
    it = iter(readings)
    return settle.wait(lambda: next(it), cap_s=cap_s, clock=clock,
                       pause=clock.sleep)


def test_fast_card_settles_at_once():
    got = _wait([1.01, 1.0, 1.02])
    assert got["settled"] and got["probe_reads"] == settle.CONFIRM
    assert got["settle_s"] == pytest.approx(
        (settle.CONFIRM - 1) * settle.PAUSE_S)


def test_slow_mode_is_waited_out_and_a_fast_run_must_be_unbroken():
    got = _wait([1.19, 1.18, 1.01, 1.19, 1.0, 1.01, 1.02])
    assert got["settled"] and got["probe_reads"] == 7
    assert got["probe_us_first"] == 1.19 and got["probe_us_last"] == 1.02


def test_wait_stops_at_its_cap_unsettled():
    got = _wait([1.2] * 100, cap_s=0.5)
    assert not got["settled"]
    assert 0.5 <= got["settle_s"] < 0.5 + 2 * settle.PAUSE_S
