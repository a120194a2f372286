"""The fleet legs of the port's check_async at tiny size on the CPU:
``--push-chaos`` (a relay killed at its second ``param_push``, counted)
and ``--chaos`` (a server killed by ``kill@t=``, a wall-clock arm; it
passed five runs in a row under the tier-1 command's ``-n 6``)."""

from tests.test_torch_chaos_legs_cli import assert_leg_passes


def test_push_chaos_leg():
    out = assert_leg_passes("--push-chaos")
    assert "OK[push-chaos]" in out and "fault_kill" in out


def test_chaos_leg():
    out = assert_leg_passes("--chaos")
    assert "OK[chaos]" in out and "trace_report --flight" in out
