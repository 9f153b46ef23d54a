"""Acceleration structures: the uniform grid (``accel/grid``)."""
