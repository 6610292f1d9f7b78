"""Analysis helpers: the roofline combiner every report and the
calibration fit use (``roofline``)."""

from . import roofline

__all__ = ["roofline"]
