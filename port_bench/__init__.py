"""The benchmark of the PyTorch and CUDA port (`v2a_tpu_torch`).

`run.py` runs one cell of `BENCHMARK.json` once; `spec.py` finds a cell's
configuration, traffic mix, the driver of its kind (`kinds/`), limits and
per-layer metric readers by name; `cells.py` holds what the drivers share;
`trace.py` reads the profiler;
`roofline.py` holds the peaks and the cost arithmetic; `reference/` is the
plain float32 copy that decides `correct`; `control.py` takes the readings
that the limits are set from.
"""
