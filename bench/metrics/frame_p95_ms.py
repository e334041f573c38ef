"""The 95th percentile (linear interpolation) of every frame completed in
the window: from the moment its viewer asked for it to the moment its
last work item's colours were back on the host."""
import numpy as np


def read(out):
    lat = out.records.get("frame_ms")
    return float(np.percentile(lat, 95)) if lat else None
