"""Percent of the traced window in which the card is idle while the host's
innermost program span is the fusion's: ``fusion`` or one of its parts
(``fusion_upload``, the copies that wait for the stream; ``fusion_read``,
the deliberate host reads; ``fusion_cull``, ``fusion_integrate`` and
``fusion_render``, the enqueue of the rest)."""

from benchmark.harness.program import idle_in

FUSION = ("fusion", "fusion_upload", "fusion_read", "fusion_cull",
          "fusion_integrate", "fusion_render")


def read(trace):
    return idle_in(trace, FUSION)
