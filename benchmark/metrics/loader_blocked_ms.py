"""Host ms a batch request blocks on the loader's workers (the program's
``loader_blocked`` span, one a request), median over the window's
requests."""

from benchmark.harness.program import median_span_ms


def read(trace):
    return median_span_ms(trace, "loader_blocked")
