"""Milliseconds per sweep of the estimator's LiDAR odometry: the
program's ``lidar_odom.sweep`` spans (``LidarFrontend.process_sweep``:
deskew, downsamples, the Gaussian voxel map, scan-to-scan VGICP and the
pack's harvest) outside the profiled part, total over count (host
clock); nothing where the program records no such span."""

from slambench.program_records import window_mean_ms


def read(ctx):
    return window_mean_ms(ctx.counters, "lidar_odom.sweep")
