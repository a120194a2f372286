"""The verifier-fleet leg of the port's check_async at tiny size on the
CPU: ``--verifier-chaos`` (a grader killed by ``kill@t=``, the lane's
refill, a task mixture, the slow-verifier A/B).  It passed five runs in
a row under the tier-1 command's ``-n 6``."""

from tests.test_torch_chaos_legs_cli import assert_leg_passes


def test_verifier_chaos_leg():
    out = assert_leg_passes("--verifier-chaos")
    assert "OK[verifier-chaos]" in out
