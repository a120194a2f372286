"""The guard-plane legs of the port's check_async at tiny size on the
CPU: ``--nan-chaos`` (NaN gradients quarantined, a NaN streak rolled back
and replayed bit for bit, a corrupted push refused and retried) and
``--trainer-chaos`` (a hung train MFC caught by the master's deadline, a
save killed between stage and flip, a torn checkpoint).  Their faults are
counted (``point=...&skip=...&times=...``), not timed."""

from tests.test_torch_chaos_legs_cli import assert_leg_passes


def test_nan_chaos_leg():
    out = assert_leg_passes("--nan-chaos")
    assert out.count("OK[nan-chaos]") == 3


def test_trainer_chaos_leg(tmp_path):
    out = assert_leg_passes("--trainer-chaos", "--dir", str(tmp_path))
    assert out.count("OK[trainer-chaos]") == 2
