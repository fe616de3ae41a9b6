"""Host ms of a tracked frame's ``track_frame`` (retries included), median
over the window's frames (the Timer's interval, which ends in the frame's
one packed read)."""

from benchmark.harness.readers import median


def read(trace):
    return median(trace.spans.get("track_frame", []))
