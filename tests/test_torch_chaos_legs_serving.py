"""The serving legs of the port's check_async at tiny size on the CPU:
``--agents`` (episodes on persistent KV slots) and the default run
(parts 1 and 2: in-memory pushes into a live stream, the replay-driven
trainer plane)."""

from tests.test_torch_chaos_legs_cli import assert_leg_passes


def test_agents_leg():
    out = assert_leg_passes("--agents")
    assert "OK[agents]" in out and "decode_compiles=1" in out


def test_default_run(tmp_path):
    out = assert_leg_passes("--dir", str(tmp_path))
    assert "OK[serving]" in out and "OK[trainer]" in out
