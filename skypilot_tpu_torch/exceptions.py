"""The port's copy of the reference's base error class
(`skypilot_tpu/exceptions.py`), for the errors it raises where the
reference raises one of its own."""


class SkyTpuError(Exception):
    """Base class for all framework errors."""
