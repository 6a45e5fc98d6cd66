"""Sensor-seconds per wall-second of the window: the sensor time that the
stream covered in the window over the window's wall time (host clock,
from the first message to the system's flush and a synchronize)."""


def read(ctx):
    return ctx.result["sensor_s"] / ctx.result["window_s"]
