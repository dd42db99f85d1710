"""Host-side observability helpers of the port (the clock, so far)."""
