"""The pipeline-overlap leg of the port's check_async at tiny size on the
CPU (``--overlap``).  Marked slow: its verdict rests on a wall-clock A/B
(the overlapped step must beat the barrier's), and on the CPU the port's
overlapped step does not: each chunk's generate call pays the decode
loop's per-step host cost again (ROADMAP queue 3)."""

import pytest

from tests.test_torch_chaos_legs_cli import assert_leg_passes


@pytest.mark.slow
def test_overlap_leg(tmp_path):
    out = assert_leg_passes("--overlap", "--dir", str(tmp_path), timeout=900)
    assert "OK[overlap]" in out
