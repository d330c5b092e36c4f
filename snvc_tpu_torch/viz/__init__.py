"""Renders without matplotlib (port of snvc_tpu/viz): LiDAR top views
(``lidar``), cuboids over frames with hidden lines (``tracebox``) and the
refinement debug panels (``debug``), drawn into numpy arrays with
``geometry/raster`` and written with ``data/png.encode_png``."""
