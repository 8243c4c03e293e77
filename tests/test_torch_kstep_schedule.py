"""The k-step kernel's march (``kstep_kernel`` of csrc/collide_stream_3d.cuh)
through its pure-Python model ``march_schedule``: the kernel runs only on
the card, so its schedule is held here. Each segment of X is marched as
the kernel marches it; the rings are replayed phase by phase (a phase is
the work between two ``__syncthreads``: one sweep's plane), and every
ring read must find the plane it pulls from (x - 1, x, x + 1: the pulls
and the outflow staging's x - t, |t_x| <= 1), written in an earlier phase
of the same segment and not overwritten since."""

import pytest

from xlb_tpu_torch.kernels.collide_stream_2step import RING, SEGMENT_MAX, march_schedule, segment_length

XS = (1, 2, 44, 100, 256)


def replay(X, segment, steps):
    """Replay the rings; returns {output plane x: times written}."""
    written = {}
    for phases in march_schedule(X, segment, steps):
        rings = {s: [None] * RING for s in range(1, steps)}  # ring s: slot -> plane; a new segment starts empty
        for s, x, slot, reads in phases:
            assert (slot is None) == (s == steps)
            assert len(reads) == (0 if s == 1 else 3)
            for (plane, rslot), want in zip(reads, (x - 1, x, x + 1)):
                assert plane == want
                # written in an earlier phase, not overwritten since; a phase's writes and reads never meet a slot
                assert rings[s - 1][rslot] == plane, (X, segment, steps, s, x, rslot, rings[s - 1])
            if s == steps:
                written[x] = written.get(x, 0) + 1
            else:
                rings[s][slot] = x
    return written


@pytest.mark.parametrize("steps", (2, 3))
@pytest.mark.parametrize("X", XS)
def test_march_writes_every_plane_once_and_reads_its_ring(X, steps):
    for segment in sorted({1, 3, 7, X, max(1, X // 2), max(1, X // 3)}):
        assert replay(X, segment, steps) == {x: 1 for x in range(X)}


@pytest.mark.parametrize("steps", (2, 3, 4))
def test_march_phases(steps):
    """A __syncthreads after every sweep; sweep 1 starts k - 1 planes before
    its segment and sweep s lags two march steps behind sweep s - 1, so a
    segment of L planes takes L + 2(k - 1) march steps."""
    (phases,) = march_schedule(5, 5, steps)
    assert phases[0][:2] == (1, -(steps - 1))
    assert [x for s, x, _, _ in phases if s == steps] == list(range(5))
    assert len(phases) == sum(5 + 2 * (steps - s) for s in range(1, steps + 1))
    assert max(i for i, (s, _, _, _) in enumerate(phases) if s == 1) < len(phases) - 1


def test_segment_rule():
    # no segment longer than SEGMENT_MAX, and within it the fewest waves x march steps: 256^3 at 8x32,
    # 256 columns on 264 slots (two blocks per SM)
    L = segment_length(256, 256, 264, 2)
    assert L == SEGMENT_MAX
    # the D=48 tunnel, 576x288x288, at 8x32: 324 columns on 264 slots
    L = segment_length(576, 36 * 9, 264, 2)
    waves = -(-36 * 9 * -(-576 // L) // 264)
    assert L <= SEGMENT_MAX and all(waves * (L + 2) <= -(-36 * 9 * -(-576 // m) // 264) * (m + 2)
                                    for m in range(1, SEGMENT_MAX + 1))
    # few columns: X is split until the slots fill
    assert segment_length(100, 4, 264, 2) < 10
    for X in XS:
        for cols in (1, 6, 200):
            assert 1 <= segment_length(X, cols, 132, 3) <= min(X, SEGMENT_MAX)
