"""Analysis helpers: the roofline combiner every report and the
calibration fit use (``roofline``), and the kernel-aware HBM traffic
model the serving simulator prices steps with (``traffic``)."""

from . import roofline, traffic

__all__ = ["roofline", "traffic"]
