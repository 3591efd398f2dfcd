"""Host-side utilities of the port (the request timeline)."""
